"""The share of the video workers' jobs that the consumer found already
queued when it took them, %: the program's counter
`h36x.extract.jobs_ready` over the calls of the span `h36x.extract.job`,
summed over the window's calls as the program kept them
(`h36x_torch.utils.profiling.measured_calls`), set-up's warm call on one
video left out as in `feed_wait_share.extract`. None outside a traced run,
and where the program keeps no calls, the window none, or none of its
calls the counter (a program whose feed does not count it)."""

COUNTER = "h36x.extract.jobs_ready"
JOB = "h36x.extract.job"
CALL = "h36x.extract.call"


def read(rec):
    if not rec.get("trace"):
        return None
    try:
        from h36x_torch.utils.profiling import measured_calls
    except ImportError:
        return None
    window = measured_calls(CALL)[1:]
    if not any(COUNTER in c["counts"] for c in window):
        return None
    jobs = sum(c["host_s"].get(JOB, (0.0, 0))[1] for c in window)
    if not jobs:
        return None
    return 100.0 * sum(c["counts"].get(COUNTER, 0) for c in window) / jobs
