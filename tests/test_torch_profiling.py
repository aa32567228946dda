"""Port: utils/profiling.py (the JAX package's test_profiling_utils,
tests/test_training.py), its Chrome trace and annotations, the step spans
(a recorder's marks, a chunk's read of them, train()'s timing keys and
trace ranges), kernel #2's launched-tile tally, and train() under
debug_nans, whose steps run eagerly."""

import json
import types

import pytest
import torch

from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp
from nerf_for_angiography_tpu_torch.training import TrainConfig, train
from nerf_for_angiography_tpu_torch.training.graph import (
    SpanTotals,
    TrainChunk,
    add_launches,
    captured_launches,
)
from nerf_for_angiography_tpu_torch.utils.profiling import (
    SpanRecorder,
    annotate,
    debug_nans,
    nan_checks_on,
    trace,
)

STAGES = ("step/sample", "step/grid", "step/march", "step/mlp_fwd", "step/composite",
          "step/backward", "step/optimizer")


def test_profiling_utils():
    with debug_nans(True):
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor(-1.0))
    assert not nan_checks_on()
    torch.log(torch.tensor(-1.0))  # unchecked outside the block
    with debug_nans(False):
        torch.log(torch.tensor(-1.0))


def test_debug_nans_leaves_allocations_unchecked():
    """An allocation's memory is not written yet (it may hold NaN bits):
    only what an operation computes is checked."""
    with debug_nans(True):
        buf = torch.empty(1 << 16)
        buf.fill_(1.0)
        buf.new_empty((8,)).zero_()
        with pytest.raises(FloatingPointError, match="aten.fill_"):
            buf.fill_(float("nan"))


def test_debug_nans_checks_the_backward():
    """A NaN that first appears in the backward (sqrt at 0: 0 * inf) raises
    at the backward's operation."""
    x = torch.zeros(1, requires_grad=True)
    with debug_nans(True), pytest.raises(FloatingPointError, match="NaN in the output"):
        (torch.sqrt(x) * 0.0).sum().backward()


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() writes a JSON Chrome trace (which Perfetto opens) holding the
    annotated region and the operations inside it."""
    with trace(str(tmp_path / "prof")), annotate("ray-march"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ray-march" in names
    assert any("mm" in str(n) for n in names)


def test_annotate_outside_a_trace_is_a_plain_block():
    with annotate("nothing traced"):
        x = torch.ones(3) * 2
    assert torch.equal(x, torch.full((3,), 2.0))


class _FakeCudaState:
    """A state whose step counter reads as a card's (TrainChunk dispatches
    on its device)."""

    step_dev = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))
    step = 0


def test_chunk_steps_eagerly_under_debug_nans(monkeypatch):
    """On the card a chunk warms each kind up eagerly and then captures it;
    under debug_nans every step is eager and nothing is captured."""
    calls = []
    monkeypatch.setattr(TrainChunk, "_eager", lambda self, s, r: calls.append("eager"))

    def capture(self, kind, s, r):
        calls.append("capture")
        return types.SimpleNamespace(replay=lambda s: calls.append("replay"))

    monkeypatch.setattr(TrainChunk, "_capture", capture)
    chunk = TrainChunk(body=None, kind_of=lambda s: None, steps_per_call=3)
    with debug_nans(True):
        for _ in range(3):
            chunk.step(_FakeCudaState(), None)
    assert calls == ["eager"] * 3 and not chunk.graphs
    calls.clear()
    for _ in range(3):
        chunk.step(_FakeCudaState(), None)
    assert calls == ["eager", "capture", "replay", "replay"]


def test_a_block_that_raises_leaves_no_recorder_active():
    """A step that raises (a failed capture) leaves its recorder unread:
    nothing more is marked into it, and annotate records nowhere after."""
    from nerf_for_angiography_tpu_torch.utils import profiling

    with pytest.raises(ValueError), SpanRecorder() as rec:
        with annotate("step/march"):
            raise ValueError("the step failed")
    assert profiling._recorder is None and rec.n == 1
    with annotate("step/march"):
        pass
    assert rec.n == 1


@pytest.fixture(scope="module")
def sphere_rays():
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )

    return generate_dataset(
        make_sphere_volume(res=32, device="cpu"),
        DatagenConfig(limited_size=90.0, number_angles=1.0, img_width=12, img_height=12,
                      sample_outside=100.0, stratified_depths=False), device="cpu").rays


_TINY = dict(depth_samples_per_ray=32, sample_size=8, grid_resolution=8, outside=100.0,
             n_iters=4, display_every=2, num_layers=2, num_hidden_units=16)


def test_train_under_debug_nans_runs_eager_and_says_so(sphere_rays, capsys):
    with debug_nans(True):
        res = train(TrainConfig(**_TINY), sphere_rays, src_pt_z=1500.0, device="cpu")
    assert "debug_nans: every step runs eagerly" in capsys.readouterr().out
    assert res.iters_run == 4


def test_train_under_debug_nans_raises_at_a_nan(sphere_rays):
    """A NaN pixel in the data stops the run at the first operation that
    carries it."""
    bad = sphere_rays._replace(pixel_values=sphere_rays.pixel_values.clone())
    bad.pixel_values[:] = float("nan")
    with debug_nans(True), pytest.raises(FloatingPointError, match="NaN in the output"):
        train(TrainConfig(**_TINY), bad, src_pt_z=1500.0, device="cpu", verbose=False)


# ---------------------------------------------------------------------------
# step spans
# ---------------------------------------------------------------------------


def test_annotate_records_nothing_without_a_recorder_or_profiler(monkeypatch):
    """Off, annotate constructs no profiler range and marks nothing."""
    def refuse(*a, **k):
        raise AssertionError("a record_function was made")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = SpanRecorder()
    with annotate("step/march"):
        torch.ones(3).sum()
    assert rec.n == 0 and rec.read() == {}


def test_recorder_nests_and_joins_the_top_level_spans():
    """Top-level spans share their boundary marks (so they partition the
    step), a span reopened right after one of its name goes on as that span,
    and a nested span takes its own marks inside its parent's."""
    with SpanRecorder() as rec:
        with annotate("a"):
            torch.ones(64).sum()
        with annotate("b"):
            with annotate("c"):
                torch.ones(64).sum()
        with annotate("b"):
            torch.ones(64).sum()
        with annotate("a"):
            pass
    assert [(n, d) for n, d, *_ in rec.spans] == [("a", 0), ("b", 0), ("c", 1), ("a", 0)]
    (_, _, a0, a1), (_, _, b0, b1), (_, _, c0, c1), (_, _, d0, d1) = rec.spans
    assert a1 == b0 and b1 == d0 and b0 < c0 < c1 < b1 and rec.n == 6
    t = rec.read()
    assert t["a"] + t["b"] == pytest.approx(t["step"])
    assert 0 <= t["c"] <= t["b"]


def test_a_cpu_step_partitions_into_its_stages(sphere_rays):
    """A chunk's CPU step under its recorder: every top-level stage opens at
    depth 0, #2's span nests inside the backward, and the stages sum to the
    step span (they share their boundaries)."""
    from nerf_for_angiography_tpu_torch.training.train import create_train_state, make_train_chunk

    cfg = TrainConfig(**_TINY)
    model, state = create_train_state(cfg, device="cpu")
    rays = sphere_rays._replace(sampling_table=None)
    chunk = make_train_chunk(model, cfg, 1400.0, 1600.0, 3)
    chunk(state, rays)
    rec = chunk._spans_of[chunk.kind_of(state)]
    names = {n for n, d, *_ in rec.spans if d == 0}
    assert names == set(STAGES)
    (bwd,) = [s for s in rec.spans if s[0] == "step/backward"]
    (mlp,) = [s for s in rec.spans if s[0] == "step/mlp_bwd"]
    assert mlp[1] == 1 and bwd[2] < mlp[2] < mlp[3] < bwd[3]
    t = rec.read()
    assert all(t[k] > 0 for k in STAGES) and t["step/mlp_bwd"] <= t["step/backward"]
    assert sum(t[k] for k in STAGES) == pytest.approx(t["step"], rel=1e-9)
    totals = SpanTotals()
    chunk.read_spans(totals)
    assert totals.span_steps == 3 and totals.chunk_replays == 3 and totals.chunks_left_out == 0
    assert totals.chunk_device_s > 0 and totals.step_ms["step"] > 0


class _FakeRecorder:
    def __init__(self, ms):
        self.ms = ms

    def read(self):
        return dict(self.ms)


def test_read_spans_weights_each_kinds_last_replay(monkeypatch):
    """Each kind's last replay counts once for every step of that kind since
    the last read; the counts reset at the read."""
    kinds = iter([None, None, 0, 0, None, None, 0, None, None])
    graphs = {None: {"step": 2.0, "step/march": 0.5}, 0: {"step": 5.0, "step/march": 1.0}}
    monkeypatch.setattr(TrainChunk, "_eager", lambda self, s, r: None)

    def capture(self, kind, s, r):
        self._spans_of[kind] = _FakeRecorder(graphs[kind])
        return types.SimpleNamespace(replay=lambda s: None)

    monkeypatch.setattr(TrainChunk, "_capture", capture)
    chunk = TrainChunk(body=None, kind_of=lambda s: next(kinds), steps_per_call=9)
    # each kind: an eager warm-up, then a capture and its replay, then replays
    for _ in range(9):
        chunk.step(_FakeCudaState(), None)
    assert chunk._replays == {None: 5, 0: 2}
    totals = SpanTotals()
    chunk.read_spans(totals)
    assert totals.span_steps == 7
    assert totals.step_ms == {"step": 5 * 2.0 + 2 * 5.0, "step/march": 5 * 0.5 + 2 * 1.0}
    assert chunk._replays == {}
    graphs[None]["step"] = 3.0  # a later replay of the kind reads anew
    kinds = iter([None, None])
    for _ in range(2):
        chunk.step(_FakeCudaState(), None)
    chunk.read_spans(totals)
    assert totals.span_steps == 9 and totals.step_ms["step"] == 20.0 + 2 * 3.0


def test_the_launched_tile_tally_is_taken_back_and_replayed():
    """Kernel #2's launched tiles and points are counted like its launches:
    a capture's counts go to its tally and back on each replay."""
    before = (fused_mlp.bwd_launches, fused_mlp.bwd_tiles, fused_mlp.bwd_points)
    with captured_launches() as tally:
        fused_mlp.bwd_launches += 1
        fused_mlp.bwd_tiles += 7
        fused_mlp.bwd_points += 100
    assert (fused_mlp.bwd_launches, fused_mlp.bwd_tiles, fused_mlp.bwd_points) == before
    for _ in range(3):
        add_launches(tally)
    assert (fused_mlp.bwd_launches, fused_mlp.bwd_tiles, fused_mlp.bwd_points) == (
        before[0] + 3, before[1] + 21, before[2] + 300)


def test_train_reports_its_spans(sphere_rays, capsys):
    """A tiny CPU train() gives every new timing key: the stages' ms over
    the stepped steps, their sum the step span, the chunk calls' span,
    kernel #2's counts (0 on the CPU: its plain version
    launches nothing), the steps' compacted marches and the verbose line."""
    res = train(TrainConfig(**_TINY, compact_samples=16), sphere_rays, src_pt_z=1500.0,
                device="cpu")
    t = res.timing
    spans = t["step_spans_ms"]
    assert t["span_steps"] == res.iters_run + 1 == t["chunk_replays"]
    assert t["chunks_left_out"] == 0
    assert set(STAGES) | {"step", "step/mlp_bwd"} == set(spans)
    assert sum(spans[k] for k in STAGES) == pytest.approx(spans["step"], rel=1e-9)
    assert spans["step"] > 0 and t["chunk_device_s"] > 0
    assert t["mlp_bwd_tiles"] == {"active": 0, "launched": 0, "points": 0, "launches": 0,
                                  "onchip": 0}
    # every compacted step marched once, on the chain (the CPU)
    assert t["march_fused"] == 0
    assert t["march_chain"] == sum(p["steps"] for p in t["steady_phases"])
    assert f"step spans (ms a step, {t['span_steps']} steps): sample=" in capsys.readouterr().out


def test_trace_of_train_holds_the_loop_phases(sphere_rays, tmp_path):
    """Under trace() a CPU train() writes loop/chunk, loop/choose and
    loop/eval ranges, and the steps' ranges and operations sit inside
    loop/chunk."""
    with trace(str(tmp_path / "prof")):
        train(TrainConfig(**_TINY, compact_samples=16), sphere_rays, src_pt_z=1500.0,
              device="cpu", verbose=False)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert {"loop/chunk", "loop/choose", "loop/eval"} <= set(spans)

    def inside(s, e):
        return any(a <= s and e <= b for a, b in spans["loop/chunk"])

    # the train step's own stages (the eval renders through step/march too)
    for name in ("step/sample", "step/mlp_bwd", "step/optimizer"):
        assert all(inside(s, e) for s, e in spans[name])
    assert any(inside(s, e) for s, e in spans["aten::mm"])
    assert not any(name.startswith("chunk/") for name in spans)  # CPU steps: no graphs
