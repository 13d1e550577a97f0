"""The seconds an extraction call takes to build its backbone and feature
function, s a call: the span `h36x.extract.load_backbone` (the model's
construction, the weights' load, the mesh and `make_feature_fn`) over its
calls, from the program's process-wide table
(`h36x_torch.utils.profiling.totals()`), which covers set-up's warm call
and every call of the window. None outside a traced run, and where the
program keeps no such table or the span never ran."""


def read(rec):
    if not rec.get("trace"):
        return None
    try:
        from h36x_torch.utils.profiling import totals
    except ImportError:
        return None
    seconds, calls = totals()["spans"].get("h36x.extract.load_backbone", (0.0, 0))
    return seconds / calls if calls else None
