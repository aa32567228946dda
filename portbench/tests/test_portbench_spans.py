"""The readers of the port's step spans and kernel #2's tile counts
(``portbench/metrics/{march_ms, composite_ms, optimizer_ms,
replay_gap_share, mlp_bwd_roofline}.py``) on a fake context: what each reads,
summed over the jobs, and nothing where the program reports no spans, no
replayed step or no #2 launch."""

from __future__ import annotations

import pytest

from portbench import run
from portbench.counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from portbench.tests.tiny import BENCH

NAMES = ("march_ms", "composite_ms", "optimizer_ms", "replay_gap_share", "mlp_bwd_roofline")
ENTRIES = [{"name": n, "unit": "ms"} for n in NAMES]


def _timing(scale: float = 1.0, steps: int = 100, **kw) -> dict:
    spans = {"step/sample": 0.01, "step/grid": 0.02, "step/march": 0.1, "step/mlp_fwd": 0.12,
             "step/composite": 0.2, "step/backward": 0.8, "step/mlp_bwd": 0.55,
             "step/optimizer": 0.05}
    spans["step"] = sum(v for k, v in spans.items() if k != "step/mlp_bwd")
    t = {"step_spans_ms": {k: v * steps * scale for k, v in spans.items()},
         "span_steps": steps, "chunk_device_s": 1.5 * steps * scale / 1e3,
         "chunk_replays": steps,
         "mlp_bwd_tiles": {"active": 7000 * steps, "launched": 35000 * steps,
                           "points": 560000 * steps, "launches": steps}}
    t.update(kw)
    return t


def _ctx(*timings) -> dict:
    return {"jobs": [{"timing": t} for t in timings], "mlp": (3, 128, 4)}


def _read(ctx) -> dict:
    return {k: v["value"] for k, v in run.read_metrics(ENTRIES, ctx, BENCH).items()}


def test_the_readers_sum_over_the_jobs():
    got = _read(_ctx(_timing(1.0, 100), _timing(2.0, 300)))
    per = (1.0 * 100 + 2.0 * 300) / 400  # the jobs' ms a step, weighted by their steps
    assert got["march_ms"] == pytest.approx(0.11 * per)
    assert got["composite_ms"] == pytest.approx((0.2 + 0.8 - 0.55) * per)
    assert got["optimizer_ms"] == pytest.approx(0.05 * per)
    step = 1.3 * per
    chunk_ms = 1.5 * (1.0 * 100 + 2.0 * 300)
    assert got["replay_gap_share"] == pytest.approx(100 * (1 - step * 400 / chunk_ms))


def test_mlp_bwd_roofline_is_the_bound_at_the_mean_launch_over_its_span():
    got = _read(_ctx(_timing(1.0, 100), _timing(1.0, 100)))["mlp_bwd_roofline"]
    n_in, f, nh = 3, 128, 4
    pt, p = 16 * 7000, 560000
    flops = 2 * (2 * pt * (n_in * f + nh * f * f + f)) + 2 * pt * (nh * f * f + n_in * f)
    weights = 2 * (16 * f + nh * f * f) + 4 * (nh + 1) * f + 4 * (f + 1)
    grads = 4 * (n_in * f + nh * f * f + (nh + 1) * f + f + 1)
    nbytes = 4 * p + 12 * pt + 12 * p + weights + grads
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
    assert got == pytest.approx(100 * bound / 0.55e-3)
    assert 0 < got < 100


def test_a_program_without_spans_gives_nothing():
    """The parent's timing has none of the keys: every reader gives nothing
    and none raises."""
    plain = {"total": 30.0, "step_dense": 1.0, "step_compact": 28.0}
    assert _read(_ctx(plain, plain)) == {}
    assert _read(_ctx(_timing(), plain)) == {}


def test_no_replayed_step_gives_nothing():
    t = _timing(steps=0)
    t["step_spans_ms"] = {}
    assert _read(_ctx(t)) == {}


def test_no_bwd_launch_gives_no_roofline():
    t = _timing(mlp_bwd_tiles={"active": 0, "launched": 0, "points": 0, "launches": 0})
    got = _read(_ctx(t))
    assert "mlp_bwd_roofline" not in got and "march_ms" in got
    del t["mlp_bwd_tiles"]
    assert "mlp_bwd_roofline" not in _read(_ctx(t))


def test_no_replay_only_chunk_gives_no_gap():
    got = _read(_ctx(_timing(chunk_device_s=0.0, chunk_replays=0)))
    assert "replay_gap_share" not in got and "optimizer_ms" in got


def _profiled(encoding=None) -> dict:
    ctx = {"jobs": [], "mlp": (3, 128, 4), "profile": {
        "device_span_s": 0.1, "train_points": 64 * 900_000, "grid_points": 4 * 524_288,
        "n_steps": 64, "kernels": {"onchip_bwd_kernel<128, (anonymous namespace)::GatedX>":
                                   [0.03, 64], "reduce_partials": [0.001, 128]}}}
    if encoding is not None:
        ctx["encoding"] = encoding
    return ctx


def _read_profiled(ctx) -> dict:
    entries = [{"name": n, "unit": "%"} for n in ("step_mfu", "mlp_bwd_ms")]
    return {k: v["value"] for k, v in run.read_metrics(entries, ctx, BENCH).items()}


def test_step_mfu_counts_the_encoded_first_layer():
    plain = _read_profiled(_profiled())
    assert plain == _read_profiled(_profiled({"name": "none", "bands": 0}))
    assert plain["step_mfu"] == pytest.approx(
        100 * (6 * 66048 * 64 * 900_000 + 2 * 66048 * 4 * 524_288) / (0.1 * PEAK_BF16_FLOPS))
    enc = _read_profiled(_profiled({"name": "fourier", "bands": 5}))
    assert enc["step_mfu"] == pytest.approx(plain["step_mfu"] * 69888 / 66048)


def test_mlp_bwd_ms_reads_nothing_in_an_encoded_cell():
    assert _read_profiled(_profiled())["mlp_bwd_ms"] == pytest.approx(1e3 * 0.031 / 64)
    assert "mlp_bwd_ms" not in _read_profiled(_profiled({"name": "barf", "bands": 5}))
