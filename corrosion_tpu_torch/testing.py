"""Test fixtures: launch a full in-process agent rig per test (port of
``corrosion_tpu/testing.py``).

Mirrors ``crates/corro-tests`` (``launch_test_agent`` + ``TEST_SCHEMA``,
``corro-tests/src/lib.rs:13-88``): the reference boots a complete real
agent (QUIC on loopback, tempdir DB, real schema) for every integration
test — no mocks. Here the analog is a small real cluster (16 nodes, 4
writers, lossless network) with the standard test schema applied, plus
optional HTTP/admin listeners. The agent runs on ``device`` (default
``"cuda"``, which raises without a card; ``"cpu"`` runs the kernels' plain
versions).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from corrosion_tpu_torch.agent import Agent
from corrosion_tpu_torch.config import Config
from corrosion_tpu_torch.db import Database

TEST_SCHEMA = """
CREATE TABLE tests (
    id INTEGER PRIMARY KEY,
    text TEXT,
    meta TEXT
);
"""


def cluster_config(**overrides) -> Config:
    """The standard small test cluster (fast first-jit, converges in a
    few rounds). Override any ``sim``/``perf``/``gossip`` field by name."""
    cfg = Config()
    cfg.sim.mode = "scale"
    cfg.sim.n_nodes = 16
    cfg.sim.m_slots = 8
    cfg.sim.n_origins = 4
    cfg.sim.n_rows = 8
    cfg.sim.n_cols = 4
    cfg.perf.sync_interval = 4
    cfg.gossip.drop_prob = 0.0
    for key, value in overrides.items():
        for section in (cfg.sim, cfg.perf, cfg.gossip):
            if hasattr(section, key):
                setattr(section, key, value)
                break
        else:
            raise AttributeError(f"no config field named {key!r}")
    return cfg


@contextlib.contextmanager
def launch_test_agent(schema: Optional[str] = TEST_SCHEMA,
                      warm_rounds: int = 10, http: bool = False,
                      admin_path: Optional[str] = None, device="cuda",
                      **overrides):
    """Boot a full agent (+Database, optional listeners) and yield a rig.

    Yields an object with ``agent``, ``db``, and (when requested)
    ``api``/``client``/``admin_path`` attributes. Always shuts down
    cleanly, like the reference's tempdir teardown."""

    class Rig:
        pass

    rig = Rig()
    with Agent(cluster_config(**overrides), device=device) as agent:
        if not agent.wait_rounds(warm_rounds, timeout=180):
            raise RuntimeError("test agent failed to warm up")
        rig.agent = agent
        rig.db = Database(agent)
        if schema:
            rig.db.apply_schema_sql(schema)
        with contextlib.ExitStack() as stack:
            if http:
                from corrosion_tpu_torch.api import ApiServer
                from corrosion_tpu_torch.client import CorrosionApiClient

                rig.api = stack.enter_context(ApiServer(rig.db, port=0))
                rig.client = CorrosionApiClient(rig.api.addr, rig.api.port)
            if admin_path:
                from corrosion_tpu_torch.admin import AdminServer

                stack.enter_context(
                    AdminServer(agent, admin_path, db=rig.db))
                rig.admin_path = admin_path
            yield rig
