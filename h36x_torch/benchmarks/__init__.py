"""Probes and benchmarks of the port; each runs on the GPU and raises without one."""
