"""The mean host milliseconds of the predict function's calls in the
window; a call ends in the copy to the host, so it holds the device's wait."""


def read(rec):
    return rec.get("device_call_ms")
