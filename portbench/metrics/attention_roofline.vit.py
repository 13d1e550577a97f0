"""The ViT's attention units' least time (portbench/roofline_vit.py) over
the device seconds of the kernels launched inside the program's
`h36x.vit.attention` spans in the traced call (portbench/span_trace.py),
%. None where the run holds no trace or no such span."""


def read(rec):
    if not rec.get("trace") or not rec.get("attention_device_s") \
            or not rec.get("attention_bound_s"):
        return None
    return 100.0 * rec["attention_bound_s"] / rec["attention_device_s"]
