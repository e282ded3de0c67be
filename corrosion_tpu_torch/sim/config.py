"""The execution-knob vocabularies the scale configs validate against
(copies of ``corrosion_tpu/sim/config.py``; a CPU test pins them equal)."""

FUSED_MODES = ("auto", "on", "off", "interpret")
QUIET_MODES = ("auto", "on", "off")
