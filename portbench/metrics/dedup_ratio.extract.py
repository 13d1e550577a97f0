"""run_extract's clip frames over the frames its backbone ran (its
summary's `dedup_ratio`)."""


def read(rec):
    return rec.get("dedup_ratio")
