"""The Fourier-feature CPPN's benchmark cell (``ct_vessel_fourier.train``)
and kernel #4's counts: a tiny cell of the configuration's settings run by
the harness on the CPU against the plain reference, #4's tallies in an
encoded job's ``timing["mlp_bwd_tiles"]``, and (on the card) #4's active
tiles in the device counter. This file imports no JAX: its card tests run
with ``python -m pytest --noconftest -m cuda tests/test_torch_fourier_cell.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import pytest
import torch

from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe
from nerf_for_angiography_tpu_torch.training import TrainConfig, train
from portbench import run
from portbench.tests import tiny

TILE = 16


def _config_train(name: str) -> dict:
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["train"]


def _fourier_train(**kw) -> dict:
    """The tiny cell's settings with what ``ct_vessel_fourier`` sets apart
    from ``ct_vessel``: the encoding, its L bands and sigma."""
    plain, fourier = _config_train("ct_vessel"), _config_train("ct_vessel_fourier")
    enc = {k: v for k, v in fourier.items() if plain.get(k) != v}
    assert enc == {"pos_enc": "fourier", "pos_enc_basis": 5, "fourier_sigma": 5.0}
    return tiny.tiny_train(**enc, **kw)


def test_a_tiny_fourier_cell_is_correct_against_the_plain_reference(tmp_path):
    """The harness's whole run of a tiny cell of the Fourier settings, in a
    process of its own (the benchmark refuses a process that holds JAX, and
    this test process holds it for the reference package's tests): two
    jobs, finite PSNR, and every check within the tiny cell's limits, the
    coefficients' leaf among ``start``, ``grad`` and ``change``'s."""
    root, bench = tiny.make_root(str(tmp_path), train=_fourier_train())
    code = ("import json; from portbench import run; "
            f"r = run.run_cell({tiny.WORKLOAD!r}, 2**31 + 7, 0.0, False, root={root!r}, "
            f"bench={bench!r}, device='cpu', look_for_chip=False); print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": tiny.REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result is not None, proc.stderr[-4000:]
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert result["checks"]["start"]["value"] == 0.0
    assert 0 < result["checks"]["change"]["value"] <= result["checks"]["change"]["limit"]
    assert result["metrics"]["heldout_psnr_db"]["value"] > 0


class _FakeEncLib:
    """kernel #4's library without a card: the sizes the wrapper allocates
    by, and a backward that launches nothing."""

    def __init__(self):
        self.calls = 0

    def fused_mlp_enc_sizes(self, f, nh, ke, n_enc, n_sms, out):
        grad_n = ke * f + nh * f * f + (nh + 1) * f + f + 1
        (ctypes.c_longlong * 6).from_address(out)[:] = [
            1024, -(-grad_n // 64) * 64, grad_n, n_sms * 8 * (nh + 1) * 32, 64, n_sms * 8 * ke]

    def fused_mlp_enc_scratch_rows(self, p):
        return -(-p // TILE) * TILE

    def fused_mlp_enc_bwd(self, *args):
        self.calls += 1
        return 0


@pytest.fixture
def counted_enc_bwd(monkeypatch):
    """Kernel #4's wrapper, counting as on the card (a fake library), under
    the encoded autograd's backward; the gradients are the plain version's.
    Yields the points of each backward."""
    points = []
    monkeypatch.setattr(fe, "_lib", _FakeEncLib())
    monkeypatch.setattr(fe, "_num_sms", lambda dev: 4)
    monkeypatch.setattr(fm, "active_tiles", lambda dev: torch.zeros((1,), dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))

    def counted(packed, a, w, x, g):
        fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
        points.append(x.shape[0])
        return fe.fused_mlp_enc_bwd_reference(packed, a, w, x, g)

    monkeypatch.setattr(fe, "fused_mlp_enc_bwd", counted)
    yield points


def _tiny_rays():
    root_cfg = {"volume": {"make": "make_vessel_volume", "res": 24},
                "datagen_make": "DatagenConfig"}
    datagen = {"limited_size": 180.0, "number_angles": 1.0, "img_width": 12, "img_height": 12,
               "sample_outside": 100.0, "stratified_depths": False}
    return run.make_dataset(torch, root_cfg, datagen, torch.device("cpu"))


def test_an_encoded_jobs_backward_counts_are_kernel_4s(counted_enc_bwd):
    """An encoded job reports #4's launches, launched tiles and points in
    ``mlp_bwd_tiles`` (one launch a step; active 0 without a card, and no
    launch on chip); a ``none`` job beside it reports #2's alone, none
    here, as before."""
    rays, src_z = _tiny_rays()
    cfg = TrainConfig(**{**_fourier_train(), "n_iters": 5, "seed": 1})
    fm.reset_counts()
    fe.reset_counts()
    res = train(cfg, rays, src_z, log_dir=None, device="cpu", verbose=False)
    steps = res.iters_run + 1
    assert len(counted_enc_bwd) == steps
    assert res.timing["mlp_bwd_tiles"] == {
        "active": 0, "launched": sum(-(-p // TILE) for p in counted_enc_bwd),
        "points": sum(counted_enc_bwd), "launches": steps, "onchip": 0}
    assert (fe.enc_bwd_launches, fe.enc_bwd_points) == (steps, sum(counted_enc_bwd))
    assert "step/mlp_bwd" in res.timing["step_spans_ms"]

    plain = TrainConfig(**{**tiny.tiny_train(), "n_iters": 5, "seed": 1})
    res = train(plain, rays, src_z, log_dir=None, device="cpu", verbose=False)
    assert len(counted_enc_bwd) == steps
    assert res.timing["mlp_bwd_tiles"] == {"active": 0, "launched": 0, "points": 0,
                                           "launches": 0, "onchip": 0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_4_adds_its_active_tiles_into_the_counter(dev):
    """#4 at the cell's widths (4 x 128, L = 5) on a ragged P whose g is
    zero on about half of the 16-point tiles: the device counter gains the
    tiles with a nonzero g, once a launch and once a replay (a capture runs
    nothing), and the host tallies its launch, tiles and points."""
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig

    gen = torch.Generator().manual_seed(0)
    model = CPPN(CPPNConfig(num_early_layers=4, num_filters=128, pos_enc="fourier",
                            pos_enc_basis=5), generator=gen).to(dev)
    packed = fe.pack_enc_params(fm.cppn_params_to_list(model), 5)
    a, w = fe.enc_arrays("fourier", 5, model.fourier_coefficients_pts.detach())
    p = 3001
    x = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    live = torch.rand(-(-p // TILE), generator=gen) < 0.5
    g = torch.randn((p,), generator=gen) * live.repeat_interleave(TILE)[:p]
    g = g.to(dev)
    want = int(live.sum())
    assert 0.4 < want / live.numel() < 0.6
    counter = fm.active_tiles(dev)
    before = int(counter.item())
    host = (fe.enc_bwd_launches, fe.enc_bwd_tiles, fe.enc_bwd_points)
    fe.fused_mlp_enc_bwd_cuda(packed, a.contiguous(), w.contiguous(), x, g)
    torch.cuda.synchronize()
    assert int(counter.item()) - before == want
    assert (fe.enc_bwd_launches, fe.enc_bwd_tiles, fe.enc_bwd_points) == (
        host[0] + 1, host[1] + -(-p // TILE), host[2] + p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fe.fused_mlp_enc_bwd_cuda(packed, a.contiguous(), w.contiguous(), x, g)
    torch.cuda.synchronize()
    assert int(counter.item()) - before == want
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert int(counter.item()) - before == 3 * want


@pytest.mark.cuda
def test_an_encoded_train_reports_kernel_4_on_the_card(dev):
    """A short fourier train() on the card: ``step/mlp_bwd`` spans #4 inside
    ``step/backward``, and ``mlp_bwd_tiles`` holds one #4 launch a step,
    none on chip, with its active tiles from the device counter."""
    rays, src_z = run.make_dataset(
        torch, {"volume": {"make": "make_vessel_volume", "res": 48},
                "datagen_make": "DatagenConfig"},
        {"limited_size": 180.0, "number_angles": 2.0, "img_width": 32, "img_height": 32,
         "sample_outside": 100.0, "stratified_depths": False}, dev)
    cfg = TrainConfig(**{**_fourier_train(sample_size=16, depth_samples_per_ray=64,
                                          grid_resolution=32),
                         "n_iters": 300, "display_every": 100, "seed": 1})
    res = train(cfg, rays, src_z, log_dir=None, device=dev, verbose=False)
    t = res.timing
    spans = t["step_spans_ms"]
    assert 0 < spans["step/mlp_bwd"] < spans["step/backward"]
    tiles = t["mlp_bwd_tiles"]
    assert tiles["launches"] == res.iters_run + 1 and tiles["onchip"] == 0
    assert 0 < tiles["active"] <= tiles["launched"] and tiles["points"] <= 16 * tiles["launched"]
