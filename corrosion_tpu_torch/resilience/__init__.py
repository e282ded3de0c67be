"""Preemption-safe recovery (port of ``corrosion_tpu/resilience/``):
segmented soak runs, checkpoint retention and the watchdog supervisor.

- :mod:`segments` — split a long run into K-round segments, threading the
  full carry (state + PRNG key) so the segmented run is bitwise identical
  to the straight one, with a crash-consistent checkpoint after every
  segment;
- :mod:`async_ckpt` — the double-buffered background checkpoint writer:
  the hot loop pays only the device-to-host copy;
- :mod:`retention` — keep-last-K pruning plus an atomic ``LATEST``
  pointer naming the newest committed checkpoint;
- :mod:`supervisor` — deadline-and-retry watchdog around device dispatch;
- :mod:`chaos` — seeded fault scenarios over the segmented runner, judged
  by the convergence, checkpoint-lineage and quiescence oracles;
- :mod:`fuzz` — generated scenarios, the shrinker and the corpus.

The JAX package's ``serve_overload`` (host-plane overload scenario) is not
ported yet.
"""

from corrosion_tpu_torch.resilience.async_ckpt import (  # noqa: F401
    AsyncCheckpointWriter,
    write_segment_checkpoint,
)
from corrosion_tpu_torch.resilience.retention import (  # noqa: F401
    latest_valid_checkpoint,
    prune_checkpoints,
    read_latest,
    update_latest,
)
from corrosion_tpu_torch.resilience.segments import (  # noqa: F401
    SoakResult,
    restore_soak_carry,
    resume_segmented,
    run_segmented,
)
from corrosion_tpu_torch.resilience.supervisor import (  # noqa: F401
    DispatchTimeout,
    Supervisor,
    SupervisorAborted,
)
