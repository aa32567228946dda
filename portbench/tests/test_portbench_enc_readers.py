"""The readers of the encoded MLP kernels (``portbench/metrics/{
enc_fwd_roofline, enc_bwd_ms, enc_bwd_roofline}.py``) on synthetic contexts,
against figures worked out by hand, and nothing where the cell has no
encoding or the program reports nothing to read; and the
``ct_vessel_fourier.train`` cell's files."""

from __future__ import annotations

import json
import os

import pytest

from portbench import check, run
from portbench.tests.tiny import BENCH

NAMES = ("enc_fwd_roofline", "enc_bwd_ms", "enc_bwd_roofline")
FOURIER = {"name": "fourier", "bands": 5}
ENC_X = "(anonymous namespace)::GatedEncX<48, true>"
CHAIN = f"void (anonymous namespace)::bwd_chain_kernel<128, {ENC_X} >"
WGRAD = f"void (anonymous namespace)::wgrad_kernel<128, {ENC_X} >"
FWD = "void (anonymous namespace)::wgmma_enc_fwd_kernel<128, 48, true>(EncX<48>, long long, Params)"


def _profile(fwd_count: int = 3) -> dict:
    # two steps' marches of 900,000 points and one grid update of 524,288;
    # #3 took 0.5 ms in all, #4's chain 1.2 ms, its weight gradients 0.6 ms,
    # the two partial sums 0.02 ms, and a march kernel 0.3 ms
    return {"n_steps": 2, "fwd_points": [900_000, 900_000, 524_288],
            "kernels": {FWD: [0.5e-3, fwd_count], CHAIN: [1.2e-3, 2], WGRAD: [0.6e-3, 2],
                        "reduce_partials": [0.02e-3, 4], "first_k_kernel": [0.3e-3, 2]}}


def _timing(**kw) -> dict:
    # 100 replayed steps, #4 0.9 ms a step; each launch 900,000 points, 12,000
    # of its 56,250 tiles active
    t = {"step_spans_ms": {"step": 200.0, "step/backward": 120.0, "step/mlp_bwd": 90.0},
         "span_steps": 100, "chunk_device_s": 0.2, "chunk_replays": 100,
         "mlp_bwd_tiles": {"active": 12_000 * 100, "launched": 56_250 * 100,
                           "points": 900_000 * 100, "launches": 100, "onchip": 0}}
    t.update(kw)
    return t


def _ctx(encoding=FOURIER, profile=None, timings=None) -> dict:
    ctx = {"mlp": (3, 128, 4), "profile": _profile() if profile is None else profile,
           "jobs": [{"timing": t} for t in (timings or [_timing()])]}
    if encoding is not None:
        ctx["encoding"] = encoding
    return ctx


def _read(ctx) -> dict:
    entries = [{"name": n, "unit": "%"} for n in NAMES]
    return {k: v["value"] for k, v in run.read_metrics(entries, ctx, BENCH).items()}


def test_enc_fwd_roofline_is_3s_bound_over_its_time():
    # E = 33: 69,888 weights, two operations each a point, all bound by
    # operations at 989 TFLOP/s (16 B a point and 142,656 B of weights
    # would take 4.3 us at 3.35 TB/s a march)
    ops = 2 * 69_888 * (900_000 * 2 + 524_288)
    assert ops == 324_879_679_488
    bound = ops / 989e12
    assert _read(_ctx())["enc_fwd_roofline"] == pytest.approx(100 * bound / 0.5e-3)
    assert _read(_ctx())["enc_fwd_roofline"] == pytest.approx(65.6986, rel=1e-5)


def test_enc_bwd_ms_is_4s_kernels_a_step():
    assert _read(_ctx())["enc_bwd_ms"] == pytest.approx((1.2 + 0.6 + 0.02) / 2)


def test_enc_bwd_roofline_is_4s_bound_at_the_mean_launch_over_its_span():
    pt = 16 * 12_000  # active points a launch
    ops = 2 * (2 * pt * 69_888) + 2 * pt * (4 * 128 * 128 + 33 * 128) + 2 * 30 * pt
    assert ops == 80_473_344_000
    # bytes: g, dx of 900,000 points (16 B), x of the active ones (12 B), the
    # packed weights (48-column input layer), the gradients, 15 coefficients
    # in and out; at 3.35 TB/s far under the operations' 81.4 us
    nbytes = 16 * 900_000 + 12 * pt + 146_436 + 282_116 + 120
    assert nbytes / 3.35e12 < ops / 989e12
    assert _read(_ctx())["enc_bwd_roofline"] == pytest.approx(100 * ops / 989e12 / 0.9e-3)
    assert _read(_ctx())["enc_bwd_roofline"] == pytest.approx(9.04093, rel=1e-5)


def test_the_readers_sum_the_jobs_counts():
    one = _read(_ctx(timings=[_timing()]))["enc_bwd_roofline"]
    assert _read(_ctx(timings=[_timing(), _timing()]))["enc_bwd_roofline"] == pytest.approx(one)


@pytest.mark.parametrize("encoding", [None, {"name": "none", "bands": 0}])
def test_a_cell_without_an_encoding_gives_nothing(encoding):
    assert _read(_ctx(encoding)) == {}


def test_another_count_of_3s_launches_gives_no_forward_roofline():
    got = _read(_ctx(profile=_profile(fwd_count=4)))
    assert "enc_fwd_roofline" not in got and set(got) == {"enc_bwd_ms", "enc_bwd_roofline"}


def test_an_untraced_run_gives_no_device_metric():
    ctx = _ctx()
    ctx["profile"] = None
    assert set(_read(ctx)) == {"enc_bwd_roofline"}


def test_a_program_without_4s_span_or_counts_gives_no_backward_roofline():
    """The parent's encoded job: #4 outside any ``step/mlp_bwd`` span, and
    ``mlp_bwd_tiles`` counting #2 alone, which never launched."""
    spans = {"step": 200.0, "step/backward": 120.0}
    none = {"active": 0, "launched": 0, "points": 0, "launches": 0, "onchip": 0}
    for t in (_timing(step_spans_ms=spans), _timing(mlp_bwd_tiles=none)):
        got = _read(_ctx(timings=[t]))
        assert "enc_bwd_roofline" not in got and "enc_bwd_ms" in got
    plain = {"total": 30.0, "step_dense": 1.0, "step_compact": 28.0}
    assert "enc_bwd_roofline" not in _read(_ctx(timings=[plain]))


def test_the_fourier_cell_loads_and_its_limits_have_every_check():
    spec = run.load_cell("ct_vessel_fourier.train")
    train, _, _ = run.settings(spec["config"], spec["traffic"], 1)
    assert check.reference.unmodelled(train) == []
    assert (train["pos_enc"], train["pos_enc_basis"], train["fourier_sigma"]) == ("fourier", 5, 5.0)
    assert check.reference_spec(train, 1500.0)["widths"][0] == 33
    assert set(check.load_limits("ct_vessel_fourier.train")) == set(check.CHECKS)
    assert {m["name"] for m in spec["per_layer"]} >= set(NAMES)
    assert not {"mlp_fwd_roofline", "mlp_bwd_ms", "mlp_bwd_roofline"} & {
        m["name"] for m in spec["per_layer"]}


def test_the_fourier_configuration_is_ct_vessels_with_the_encoding():
    def body(name):
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            return json.load(f)

    plain, fourier = body("ct_vessel"), body("ct_vessel_fourier")
    assert fourier["reduced"] == [] and fourier["assumed"][:-1] == plain["assumed"]
    for key in set(plain) - {"name", "source", "assumed", "train"}:
        assert fourier[key] == plain[key], key
    changed = {k: v for k, v in fourier["train"].items() if plain["train"].get(k) != v}
    assert changed == {"pos_enc": "fourier", "pos_enc_basis": 5, "fourier_sigma": 5.0}
    assert set(plain["train"]) <= set(fourier["train"])
