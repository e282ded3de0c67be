"""The port's cost model on its scan entries (``analysis/cost.py``), on the
CPU: every scan entry's per-round fit (2 rounds minus 1, the marginal round
a sync-and-sweep round, the quiet entry's a dense one) is exact on its
holdouts with the degrees of the JAX package's fits, and the static 1M
roofline projects from them. JAX's fits of ``sharded_scale_run`` and
``quiet_scale_run`` are made here; the others' degrees come from the JAX
package's committed probe record, which those two hold current."""

import json
import os

import pytest

from corrosion_tpu.analysis import cost as jcost
from corrosion_tpu_torch.analysis import cost

SCAN_ENTRIES = ("segment_dispatch", "segmented_soak", "sharded_scale_run",
                "fused_scale_run", "quiet_scale_run")
LIVE_JAX = ("sharded_scale_run", "quiet_scale_run")
JAX_RECORD = os.path.join(os.path.dirname(__file__), "..", "artifacts", "cost_r20.json")
_JFITS: dict = {}


def _fit(name):
    return cost.fit_for_config(cost.PRICED_ENTRY_POINTS[name].template(), name, "cpu")


def _jax_degrees(name) -> dict:
    """{metric: {symbol: degree}} of the JAX package's fit of ``name``."""
    if name in LIVE_JAX:
        if name not in _JFITS:
            _JFITS[name] = jcost.fit_entry(name)
        return {m: {s: f.degree(s) for s in f.extents} for m, f in _JFITS[name].items()}
    with open(JAX_RECORD) as f:
        return {m: rec["degrees"] for m, rec in json.load(f)["fits"][name].items()}


@pytest.mark.parametrize("name", LIVE_JAX)
def test_jax_probe_record_is_current(name):
    _jax_degrees(name)
    with open(JAX_RECORD) as f:
        record = json.load(f)["fits"][name]
    for metric, fit in _JFITS[name].items():
        assert record[metric]["poly"] == fit.render()


@pytest.mark.parametrize("name", SCAN_ENTRIES)
def test_scan_fit_exact_with_jax_degrees(name):
    fits = _fit(name)
    for metric, fit in fits.items():
        assert fit.exact, (name, metric, fit.render())
        assert {s: fit.degree(s) for s in fit.extents} == _jax_degrees(name)[metric], fit.render()


def test_roofline_projects_the_exact_fits():
    roof = cost.roofline(device="cpu")
    assert roof["point"] == cost.ROOFLINE_POINT
    for name, rec in roof["entries"].items():
        fits = _fit(name)
        for metric in ("flops", "hbm_bytes"):
            assert rec[metric + "_fit_exact"]
            assert rec[metric + "_per_round"] == fits[metric].at(cost.ROOFLINE_POINT)
            assert rec[metric + "_poly"] == fits[metric].render()
    # the kernel route and the placement price the same program
    assert roof["entries"]["fused_scale_run"]["flops_poly"] == (
        roof["entries"]["sharded_scale_run"]["flops_poly"])


def test_projected_flops_follows_the_live_config():
    cfg = cost.PRICED_ENTRY_POINTS["sharded_scale_run"].template()
    assert cost.projected_flops(cfg, 1_000_000, device="cpu") == (
        _fit("sharded_scale_run")["flops"].at(cost.ROOFLINE_POINT))


def test_per_round_is_two_rounds_minus_one():
    env = {"N": 64, "M": 64}
    two = cost.price_entry("segment_dispatch", env, rounds=2, device="cpu")
    one = cost.price_entry("segment_dispatch", env, rounds=1, device="cpu")
    assert cost.price_per_round("segment_dispatch", env, device="cpu") == two.minus(one)
