"""State carried across (corrosion_tpu_torch/convert.py): JAX state ->
numpy -> port -> numpy must equal the original leaf for leaf, dtypes
included (the int16 narrow planes, the uint32 seen words). The same tests
guard the leaf order of every container the port mirrors."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import partials as jpartials
from corrosion_tpu.ops import versions as jversions
from corrosion_tpu.sim import broadcast as jbroadcast
from corrosion_tpu.sim import scale as jscale
from corrosion_tpu.sim import config as jconfig
from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim import step as jfull
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import transport as jtransport
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.ops import partials, versions
from corrosion_tpu_torch.sim import broadcast, config, scale, scale_step, step, swim, transport
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)


def _randomized(st, seed):
    """Every leaf of a JAX state replaced by random values of its own dtype
    and shape (full uint32 range for the seen words, negatives in the
    int16 planes)."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return jnp.asarray(rng.random(a.shape) < 0.5)
        info = np.iinfo(a.dtype)
        return jnp.asarray(rng.integers(info.min, info.max, a.shape, dtype=a.dtype,
                                        endpoint=True))

    return jax.tree.map(fill, st)


@pytest.mark.parametrize("narrow", [True, False])
def test_state_round_trip(narrow):
    cfg = jstep.scale_sim_config(48, narrow_dtypes=narrow)
    st = _randomized(jstep.ScaleSimState.create(cfg), 1)
    tree = convert.as_numpy_tree(st)
    tst = convert.scale_state_from_numpy(scale_step.scale_sim_config(48, narrow_dtypes=narrow),
                                         tree, "cpu")
    back = convert.state_to_numpy(tst)
    want, got = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert len(want) == len(got) == len(jax.tree.leaves(st))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert back["crdt"]["book"]["seen"].dtype == np.uint32
    assert tst.crdt.book.seen.dtype == torch.int32
    if narrow:
        assert tst.swim.mem_timer.dtype == torch.int16
        assert tst.crdt.q_tx.dtype == torch.int16


@pytest.mark.parametrize("narrow", [True, False])
def test_created_state_equals_jax_created_state(narrow):
    jcfg = jstep.scale_sim_config(48, narrow_dtypes=narrow)
    want = jax.tree.leaves(convert.as_numpy_tree(jstep.ScaleSimState.create(jcfg)))
    tst = scale_step.ScaleSimState.create(
        scale_step.scale_sim_config(48, narrow_dtypes=narrow), "cpu")
    got = jax.tree.leaves(convert.state_to_numpy(tst))
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_container_leaf_order():
    pairs = [
        (scale.ScaleSwimState, jscale.ScaleSwimState),
        (broadcast.CrdtState, jbroadcast.CrdtState),
        (versions.Book, jversions.Book),
        (partials.Partials, jpartials.Partials),
        (transport.NetModel, jtransport.NetModel),
        (scale_step.ScaleSimState, jstep.ScaleSimState),
        (scale_step.ScaleRoundInput, jstep.ScaleRoundInput),
        (swim.SwimState, jswim.SwimState),
        (step.SimState, jfull.SimState),
        (step.RoundInput, jfull.RoundInput),
    ]
    for ours, theirs in pairs:
        assert ours._fields == theirs._fields, ours.__name__


def test_net_inputs_and_key_round_trip():
    net = jtransport.NetModel.create(48, drop_prob=0.05, n_regions=3)
    tnet = convert.net_from_numpy(convert.as_numpy_tree(net), "cpu")
    for a, b in zip(net, tnet):
        assert np.array_equal(np.asarray(a), b.numpy()) and np.asarray(a).dtype == b.numpy().dtype
    cfg = jstep.scale_sim_config(48)
    inp = _randomized(jstep.make_write_inputs(cfg, jr.key(1), 3,
                                              jnp.ones((3, 48), bool)), 2)
    tinp = convert.round_input_from_numpy(scale_step.ScaleRoundInput, convert.as_numpy_tree(inp), "cpu")
    for a, b in zip(inp, tinp):
        assert np.array_equal(np.asarray(a), b.numpy())
    key = jr.fold_in(jr.key(77), 5)
    tkey = convert.key_from_numpy(jr.key_data(key))
    assert np.array_equal(np.asarray(jr.key_data(key)).astype(np.int64), tkey.numpy())


def test_full_state_round_trip_and_created_state():
    """The full view's state (int32 [N, N] view, timer, budget and last-sync
    planes): random leaves survive the trip, and a fresh port state equals a
    fresh JAX state leaf for leaf."""
    jcfg = jconfig.wan_config(40, tx_max_cells=1)
    tcfg = config.wan_config(40, tx_max_cells=1)
    st = _randomized(jfull.SimState.create(jcfg), 3)
    tree = convert.as_numpy_tree(st)
    back = convert.state_to_numpy(convert.full_state_from_numpy(tcfg, tree, "cpu"))
    fresh = convert.state_to_numpy(step.SimState.create(tcfg, device="cpu"))
    want_fresh = jax.tree.leaves(convert.as_numpy_tree(jfull.SimState.create(jcfg)))
    for want, got in ((jax.tree.leaves(tree), jax.tree.leaves(back)),
                      (want_fresh, jax.tree.leaves(fresh))):
        assert len(want) == len(got) == len(jax.tree.leaves(st))
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert back["crdt"]["last_sync"].shape == (40, 40)


def test_full_round_input_round_trip():
    cfg = jconfig.wan_config(40, tx_max_cells=1)
    inp = _randomized(jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape),
                                   jfull.RoundInput.quiet(cfg)), 4)
    tinp = convert.round_input_from_numpy(step.RoundInput, convert.as_numpy_tree(inp), "cpu")
    for a, b in zip(inp, tinp, strict=True):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("tiers", [dict(narrow_dtypes=False), dict(), dict(narrow_q_int8=True),
                                   "full"])
def test_plane_dtypes_follow_the_config(tiers):
    """``broadcast.plane_dtypes`` is the one rule for the queue planes' types:
    a scale config's timer and queue-counter tiers, int32 for the full view
    (whose ``SimConfig`` has no tier fields), and ``CrdtState.create`` uses it."""
    if tiers == "full":
        cfg, want = config.wan_config(40, tx_max_cells=1), (torch.int32, torch.int32)
    else:
        cfg = scale_step.scale_sim_config(48, **tiers)
        want = (cfg.timer_dtype, cfg.q_dtype)
    assert broadcast.plane_dtypes(cfg) == want
    cst = broadcast.CrdtState.create(cfg, "cpu")
    assert (cst.q_cell.dtype, cst.last_sync.dtype) == (want[0], want[0])
    assert (cst.q_tx.dtype, cst.q_seq.dtype, cst.q_nseq.dtype) == (want[1],) * 3
