"""Pipeline spans: host tracing plus an optional ``torch.profiler`` label
(port of ``corrosion_tpu/obs/spans.py``).

The soak pipeline's overlap (checkpoint serialize and IO on the
background writer while the next segment runs) is invisible in a plain
log. Wrapping the three phases (segment dispatch, the carry's host copy,
serialize) in spans shows it twice: the OTLP file export
(``utils.tracing.configure_otlp_file``) shows the wall-clock overlap, and
under ``[obs] jax_profile`` (the key keeps the JAX package's name) a
``torch.profiler.record_function`` labels the same region in a
``torch.profiler`` trace, so the card's timeline lines up with the host's.
"""

from __future__ import annotations

import contextlib

from corrosion_tpu_torch.utils import tracing


@contextlib.contextmanager
def pipeline_span(name: str, jax_profile: bool = False, **attrs):
    """A :func:`corrosion_tpu_torch.utils.tracing.span` that, with
    ``jax_profile=True``, also labels the region for ``torch.profiler``
    traces (the import is deferred so the common path never touches the
    profiler)."""
    with tracing.span(name, **attrs) as ctx:
        if jax_profile:
            from torch.profiler import record_function

            with record_function(name):
                yield ctx
        else:
            yield ctx
