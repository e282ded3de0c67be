"""Public API layer: HTTP server + client types.

Maps the reference's layer 7 (``crates/corro-agent/src/api/public/``,
routes registered at ``agent/util.rs:182-294``).
"""

from corrosion_tpu_torch.api.http import ApiServer

__all__ = ["ApiServer"]
