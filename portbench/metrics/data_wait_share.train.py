"""The host's wait on the feed's queue (train_epoch's `data` timer) over
the window, %."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * rec["data_wait_s"] / rec["window_s"]
