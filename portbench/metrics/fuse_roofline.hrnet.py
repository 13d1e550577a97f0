"""HRNet's exchange units' least time (portbench/roofline_hrnet.py, one a
module) over the device seconds of the kernels launched inside the
program's `h36x.hrnet.fuse` spans in the traced call
(portbench/span_trace.py), %. None where the run holds no trace or no
such span."""


def read(rec):
    if not rec.get("trace") or not rec.get("fuse_device_s") or not rec.get("fuse_bound_s"):
        return None
    return 100.0 * rec["fuse_bound_s"] / rec["fuse_device_s"]
