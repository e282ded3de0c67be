"""The port's per-round cost model (``analysis/cost.py``) against the JAX
package's corrocost, on the CPU: the registries, the degree gate, the
priced units (every PRNG draw priced exactly as JAX prices the jaxpr of
the same ``jax.random`` call, whatever runs inside it; a kernel wrapper
priced as its unit, not as its plain version's ops), the step entries'
exact fits with JAX's degrees, a direct count at a mid point, and the
port's count over JAX's inside JAX's own agreement band. The scan entries'
fits are in ``test_torch_cost_fits.py``."""

import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from corrosion_tpu.analysis import cost as jcost
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.analysis import cost, shapes
from corrosion_tpu_torch.ops import megakernel as mk

STEP_ENTRIES = ("scale_sim_step", "full_sim_step")
_JFITS: dict = {}


def _fit(name):
    return cost.fit_for_config(cost.PRICED_ENTRY_POINTS[name].template(), name, "cpu")


def _jfit(name):
    if name not in _JFITS:
        _JFITS[name] = jcost.fit_entry(name)
    return _JFITS[name]


def _count(fn, *args, **kwargs):
    with cost.Counter() as c:
        out = fn(*args, **kwargs)
    return c, out


def test_registries_equal_jax():
    assert cost.COST_DEGREES == jcost.COST_DEGREES
    assert cost.ROOFLINE_POINT == jcost.ROOFLINE_POINT == shapes.HBM_BUDGET["point"]
    assert list(cost.PRICED_ENTRY_POINTS) == list(jcost.PRICED_ENTRY_POINTS)
    for name, entry in cost.PRICED_ENTRY_POINTS.items():
        j = jcost.PRICED_ENTRY_POINTS[name]
        assert (entry.root, entry.extents, entry.scanned) == (j.root, j.extents, j.scanned)
        # the kernel units carry no Pallas grid: every port entry is exact
        assert entry.exact_fit


def test_degree_gate_passes():
    assert cost.check_degrees() == []
    inv = shapes.static_inventory(mode="scale")
    assert cost.inventory_degrees(inv) == cost.COST_DEGREES["ScaleSimState"]


def test_degree_gate_fires_on_an_nn_plane(monkeypatch):
    _root, build = shapes.ROOTS["scale"]

    def with_nn(cfg):
        return {"state": build(cfg),
                "zz": torch.zeros((cfg.n_nodes, cfg.n_nodes), device="meta")}

    monkeypatch.setitem(shapes.ROOTS, "scale", ("ScaleSimState", with_nn))
    problems = cost.check_degrees()
    assert len(problems) == 1 and "degree 2 in N" in problems[0]


#: (port call, JAX call) on a key, per priced draw
DRAWS = {
    "bits": (lambda k, s: prng.bits(k, s, "cpu"), lambda k, s: jr.bits(k, s)),
    "uniform": (lambda k, s: prng.uniform(k, s, "cpu"), lambda k, s: jr.uniform(k, s)),
    "uniform-bounds": (lambda k, s: prng.uniform(k, s, "cpu", 2.0, 5.0),
                       lambda k, s: jr.uniform(k, s, minval=2.0, maxval=5.0)),
    "randint": (lambda k, s: prng.randint(k, s, 0, 13, "cpu"),
                lambda k, s: jr.randint(k, s, 0, 13)),
    "split": (lambda k, s: prng.split(k, s[0]), lambda k, s: jr.split(k, s[0])),
    "fold_in": (lambda k, s: prng.fold_in(k, s[0]), lambda k, s: jr.fold_in(k, s[0])),
}


@pytest.mark.parametrize("shape", [(3,), (7, 5), (2, 3, 4)])
@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_draw_unit_priced_as_jax_prices_the_call(draw, shape):
    port, jax_call = DRAWS[draw]
    c, _ = _count(port, prng.key(3), shape)
    want = jcost.count_jaxpr(jax.make_jaxpr(lambda k: jax_call(k, shape))(jr.key(3)))
    assert (c.flops, c.hbm_bytes) == (want.flops, want.hbm_bytes)
    assert c.eqns == 1 and sum(c.units.values()) == 1


@pytest.mark.parametrize("k", [1, 3, 9])
def test_top_k_unit_priced_as_jax_prices_lax_top_k(k):
    x = torch.arange(63, dtype=torch.float32).reshape(7, 9).flip(1)
    c, (vals, idx) = _count(prng.top_k, x, k)
    want = jcost.count_jaxpr(jax.make_jaxpr(lambda a: jax.lax.top_k(a, k))(jnp.asarray(x.numpy())))
    assert (c.flops, c.hbm_bytes, c.eqns) == (want.flops, want.hbm_bytes, 1)
    assert vals.is_contiguous() and idx.is_contiguous()


def _bits_by_hand(k, shape, device):
    """``random.bits`` recomputed one word at a time in Python integers: the
    same words through entirely different ops."""
    k1, k2 = prng._words(k)
    words = []
    for i in range(int(torch.tensor(shape).prod())):
        a, b = prng._threefry(k1, k2, i >> 32, i & prng._M32)
        words.append(a ^ b)
    return torch.tensor(words, dtype=torch.int64, device=device).reshape(tuple(shape))


@pytest.mark.parametrize("draw", ["uniform", "randint"])
def test_draw_price_does_not_move_with_its_implementation(draw, monkeypatch):
    port, _ = DRAWS[draw]
    key, shape = prng.key(11), (6, 7)
    jax_way = prng.bits.__wrapped__
    c0, out0 = _count(port, key, shape)
    assert torch.equal(_bits_by_hand(key, shape, "cpu"), prng.bits(key, shape, "cpu"))
    monkeypatch.setattr(prng, "bits", _bits_by_hand)
    c1, out1 = _count(port, key, shape)
    assert torch.equal(out0, out1)
    assert c1.count() == c0.count()
    assert c0.units[draw] == 1
    # the two implementations of the words cost differently op by op
    raw_jax_way, _ = _count(jax_way, key, shape, "cpu")
    raw_by_hand, _ = _count(_bits_by_hand, key, shape, "cpu")
    assert raw_jax_way.count() != raw_by_hand.count()


def test_kernel_wrapper_on_cpu_priced_as_its_unit():
    cfg = cost.config_at(cost.PRICED_ENTRY_POINTS["scale_sim_step"].template(),
                         {"N": 64, "M": 64})
    run = cost.PRICED_ENTRY_POINTS["scale_sim_step"].build(cfg, 1, "cpu")
    with cost.Counter(keep=cost.KERNEL_UNITS) as counter:
        run()
    calls = counter.calls
    assert [name for name, *_ in calls] == ["swim_tables", "ingest", "ingest"]
    for name, args, kwargs, out, flops, nbytes in calls:
        wrapper = mk.swim_tables_fused if name == "swim_tables" else mk.ingest
        plain = mk.swim_tables_plain if name == "swim_tables" else mk.ingest_plain
        c, _ = _count(wrapper, *args)
        assert (c.flops, c.hbm_bytes, c.eqns) == (flops, nbytes, 1)
        assert nbytes == cost._nbytes(args) + cost._nbytes(tuple(out))
        p, _ = _count(plain, *args)
        assert p.eqns > 1 and p.flops != flops  # the plain version's own ops


def test_priced_round_must_take_the_sync_arm(monkeypatch):
    monkeypatch.setattr(cost, "_start_now", lambda cfg, before: 2)
    with pytest.raises(RuntimeError, match="arm"):
        cost.price_per_round("scale_sim_step", {"N": 64, "M": 64}, device="cpu")


@pytest.mark.parametrize("name", STEP_ENTRIES)
def test_step_fit_exact_with_jax_degrees(name):
    fits, jfits = _fit(name), _jfit(name)
    for metric, fit in fits.items():
        assert fit.exact, (metric, fit.render())
        assert jfits[metric].exact
        for sym in ("N", "M"):
            assert fit.degree(sym) == jfits[metric].degree(sym), (metric, sym, fit.render())
    if name == "scale_sim_step":
        assert fits["flops"].degree("N") == fits["flops"].degree("M") == 1
    else:
        assert fits["flops"].degree("N") == 2


def test_direct_count_at_a_mid_point_equals_the_fit():
    env = {"N": 4096, "M": 64}
    direct = cost.price_per_round("scale_sim_step", env, device="cpu")
    fits = _fit("scale_sim_step")
    assert (direct.flops, direct.hbm_bytes) == (fits["flops"].at(env), fits["hbm_bytes"].at(env))


#: entry -> points where the port's count is held to JAX's
RATIO_POINTS = {
    "scale_sim_step": ({"N": 64, "M": 64}, {"N": 100_000, "M": 64}, dict(cost.ROOFLINE_POINT)),
    "full_sim_step": ({"N": 64}, {"N": 8192}),
}


@pytest.mark.parametrize("name", STEP_ENTRIES)
def test_port_over_jax_count_inside_jax_agreement_band(name):
    lo, hi = jcost.XLA_AGREEMENT_BAND
    for env in RATIO_POINTS[name]:
        for metric in ("flops", "hbm_bytes"):
            ratio = _fit(name)[metric].at(env) / _jfit(name)[metric].at(env)
            print(f"{name} {env} {metric}: port / JAX = {ratio!r}")
            assert lo < ratio < hi, (name, env, metric, ratio)
