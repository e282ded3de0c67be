"""Tensor primitives of the port (counterparts of ``corrosion_tpu/ops``)."""
