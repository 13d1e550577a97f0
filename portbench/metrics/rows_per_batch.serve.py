"""The daemon's rows over its batches in the window (its `stats`,
differenced)."""


def read(rec):
    if not rec.get("batches"):
        return None
    return rec["rows"] / rec["batches"]
