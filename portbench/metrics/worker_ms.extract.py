"""A video worker's host time per frame it cropped, ms: the seconds of the
span `h36x.extract.job` (decode, crop, jitter and the worker's own copies
of one clip) over the counter `h36x.extract.frames_cropped`, from the
program's process-wide table (`h36x_torch.utils.profiling.totals()`),
which covers set-up's warm call and every call of the window. None outside
a traced run, and where the program keeps no such table or the table holds
no cropped frame."""


def read(rec):
    if not rec.get("trace"):
        return None
    try:
        from h36x_torch.utils.profiling import totals
    except ImportError:
        return None
    table = totals()
    seconds, _ = table["spans"].get("h36x.extract.job", (0.0, 0))
    frames = table["counts"].get("h36x.extract.frames_cropped", 0)
    return 1000.0 * seconds / frames if frames else None
