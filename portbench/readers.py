"""What the per-layer metric files share: each reads a driver's record
(and, in a traced run, `record["trace"]`, trace.summarize's) and returns a
number, or None where the run holds nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench.roofline import PEAK_FLOPS


def _trace(rec: dict) -> Optional[dict]:
    tr = rec.get("trace")
    return tr if tr and tr.get("busy_s", 0) > 0 else None


def mfu(rec: dict) -> Optional[float]:
    """The traced window's model operations over its length and the peak, %."""
    if not rec.get("traced_flops") or not rec.get("traced_window_s"):
        return None
    return 100.0 * rec["traced_flops"] / rec["traced_window_s"] / PEAK_FLOPS


def device_roofline(rec: dict) -> Optional[float]:
    """The units' least time over the device's busy time, %."""
    tr = _trace(rec)
    if tr is None or not rec.get("traced_bound_s"):
        return None
    return 100.0 * rec["traced_bound_s"] / tr["busy_s"]


def idle_share(rec: dict) -> Optional[float]:
    """1 - busy / window of the traced window, %."""
    tr = _trace(rec)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
