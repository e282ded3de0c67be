"""Host-side utilities of the port: the retry policy and the package's
logger (a plain ``logging`` logger; the JAX package's OTLP span exporter
is not part of the port yet)."""

import logging

logger = logging.getLogger("corrosion_tpu_torch")
