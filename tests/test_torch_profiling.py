"""Port: utils/profiling.py (the JAX package's test_profiling_utils,
tests/test_training.py), its Chrome trace and annotations, and train()
under debug_nans, whose steps run eagerly."""

import json
import types

import pytest
import torch

from nerf_for_angiography_tpu_torch.training import TrainConfig, train
from nerf_for_angiography_tpu_torch.training.graph import TrainChunk
from nerf_for_angiography_tpu_torch.utils.profiling import (
    StepTimer,
    annotate,
    debug_nans,
    nan_checks_on,
    trace,
)


def test_profiling_utils():
    t = StepTimer()
    t.start()
    t.stop()
    assert t.avg_s > 0
    assert "Time for iteration 5" in t.iteration_line(5)
    assert t.iteration_line(5) == f"Time for iteration 5 = {t.avg_s}"
    assert t.rays_per_sec(100) > 0

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
