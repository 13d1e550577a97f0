"""The seconds an extraction call takes to build its HRNet-W48 backbone
and feature function, s a call: backbone_load_s.extract's reading (the
span `h36x.extract.load_backbone` over its calls) in the cell whose
backbone is HRNet-W48, where the span holds the 302 MB float32 weights
file's load."""

from portbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "backbone_load_s.extract.py",
                   "portbench_metric_backbone_load_s_extract").read
