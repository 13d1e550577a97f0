"""HRNet's BasicBlock units' least time (portbench/roofline_hrnet.py, one
a module) over the device seconds of the kernels launched inside the
program's `h36x.hrnet.branches` spans in the traced call
(portbench/span_trace.py), %. None where the run holds no trace or no
such span."""


def read(rec):
    if not rec.get("trace") or not rec.get("branch_device_s") \
            or not rec.get("branch_bound_s"):
        return None
    return 100.0 * rec["branch_bound_s"] / rec["branch_device_s"]
