"""The share of extraction's calls that the main thread spends waiting on
the video workers (the span `h36x.extract.wait_jobs`: decode, crop and
jitter not yet done), %: the seconds over those of `h36x.extract.call`, summed
over the window's calls as the program kept them
(`h36x_torch.utils.profiling.measured_calls`). The first call is left out:
it is set-up's warm call on one video, which also builds the kernels and
the native library on a fresh checkout (several seconds, or none once
they are cached). Host seconds, not the trace's idle gaps: the trace
names a gap by the event over its middle, so one gap that runs from
`wait_jobs` through `stage` is filed whole under one of them. None outside
a traced run, and where the program keeps no calls or the window none."""

SPANS = ("h36x.extract.wait_jobs",)
CALL = "h36x.extract.call"


def read(rec):
    if not rec.get("trace"):
        return None
    try:
        from h36x_torch.utils.profiling import measured_calls
    except ImportError:
        return None
    window = measured_calls(CALL)[1:]
    call_s = sum(c["host_s"][CALL][0] for c in window)
    if not call_s:
        return None
    return 100.0 * sum(c["host_s"].get(name, (0.0, 0))[0]
                       for c in window for name in SPANS) / call_s
