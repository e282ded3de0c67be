"""The host agent: the operator-facing node runtime around the simulator
(port of ``corrosion_tpu/agent/``).

The reference's ``corro-agent`` boots one OS process per node with loops
for gossip, changes, and sync plus an HTTP API (SURVEY §3.1). Here one
host agent carries the *whole simulated cluster* (the card holds every
node's state); the API surface is per-node through an explicit ``node``
parameter — write through node A, read at node B, and convergence is
observable exactly like the reference's ``insert_rows_and_gossip`` tests.
"""

from corrosion_tpu_torch.agent.core import Agent

__all__ = ["Agent"]
