"""The multi-process runtime (counterpart of `ray_tpu.core.distributed`):
only the GPU resource primitives (`resources.py`, `accelerators.py`) are
ported; the control plane, node daemon and workers are ROADMAP queue A,
item 10a-ii."""
