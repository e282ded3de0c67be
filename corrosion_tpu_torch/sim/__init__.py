"""The scale simulator of the port (counterparts of ``corrosion_tpu/sim``)."""
