"""Port: ``Reconstruction`` against the JAX package's on run directories
written by the JAX ``train(log_dir=...)`` and by the port's
``train(log_dir=..., device="cpu")``: the same bundle and grid loaded, views
(and their binary renders) within the render tolerance of
tests/test_torch_evaluation.py, the density field and point densities
within the forward tolerance of tests/test_torch_fused_mlp.py."""

import os

import jax
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.evaluation import EvalConfig as EvalConfigJ
from nerf_for_angiography_tpu.reconstruction import Reconstruction as ReconstructionJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import train as train_j
from nerf_for_angiography_tpu_torch.evaluation import EvalConfig, render_view_pair
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.reconstruction import Reconstruction
from nerf_for_angiography_tpu_torch.training import TrainConfig, load_model, train

SMALL = dict(compact_samples=0, sample_size=8, depth_samples_per_ray=32, grid_resolution=16,
             num_layers=2, num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-2,
             n_iters=20, display_every=10)
SRC_Z = 1500.0
EVAL = dict(img_width=12, img_height=10, sample_outside=100.0, depth_samples_per_ray=32,
            outside=100.0)
PIX_ATOL = 2e-2  # tests/test_torch_evaluation.py


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """One tiny CT run of each package with log_dir (five 8x8 views of the
    sphere phantom)."""
    ds = generate_dataset_j(
        make_sphere_volume_j(res=32, extent=75.0, radius=30.0),
        DatagenConfigJ(limited_size=90.0, number_angles=1.0, img_width=8, img_height=8,
                       sample_outside=100.0, stratified_depths=False),
    )
    rays = jax.tree.map(np.asarray, ds.rays._replace(sampling_table=None))
    jax_dir = str(tmp_path_factory.mktemp("jax_run"))
    train_j(TrainConfigJ(**SMALL), rays, SRC_Z, log_dir=jax_dir, verbose=False)
    port_dir = str(tmp_path_factory.mktemp("port_run"))
    rays_t = RayDataset(*(None if a is None else torch.from_numpy(np.array(a)) for a in rays))
    train(TrainConfig(**SMALL), rays_t, SRC_Z, log_dir=port_dir, verbose=False, device="cpu")
    return {"jax": jax_dir, "port": port_dir}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reconstruction_matches_jax(run_dirs, writer):
    run_dir = run_dirs[writer]
    rec_j = ReconstructionJ.from_run_dir(run_dir, eval_config=EvalConfigJ(**EVAL))
    rec = Reconstruction.from_run_dir(run_dir, eval_config=EvalConfig(**EVAL), device="cpu")
    assert rec.meta == rec_j.meta
    _, params = load_model(os.path.join(run_dir, "highmodel.npz"))
    w = rec.model.state_dict()["input_layer.weight"].numpy()
    np.testing.assert_array_equal(w, params["params"]["input_layer"]["kernel"].T)
    np.testing.assert_array_equal(rec.grid.binary.numpy(), np.asarray(rec_j.grid.binary))
    for theta, phi in ((30.0, -45.0), (-120.0, 10.0)):
        for binary in (False, True):
            got = rec.render_view(theta, phi, binary=binary)
            want = rec_j.render_view(theta, phi, binary=binary)
            assert got.shape == want.shape == (10, 12)
            np.testing.assert_allclose(got, want, atol=PIX_ATOL)
        assert (rec.render_view(theta, phi, binary=True)
                >= rec.render_view(theta, phi) - 1e-6).all()
    # the field over the AABB ('ij') and at points
    np.testing.assert_allclose(rec.density_field(resolution=9, chunk=100),
                               rec_j.density_field(resolution=9, chunk=100), atol=2e-2)
    pts = np.random.default_rng(0).uniform(-100, 100, (2, 5, 3)).astype(np.float32)
    got = rec.density(pts)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, rec_j.density(pts), atol=2e-2)


def test_render_view_is_render_view_pair(run_dirs):
    """rec.render_view is the sweep's render_view_pair on the loaded model
    and grid, bit for bit (negative angles wrapped to 360)."""
    rec = Reconstruction.from_run_dir(run_dirs["port"], eval_config=EvalConfig(**EVAL),
                                      device="cpu")
    pred, bpred, _ = render_view_pair(rec.model, rec.grid, rec.eval_config, 240.0, 350.0,
                                      device="cpu")
    np.testing.assert_array_equal(rec.render_view(-120.0, -10.0), pred)
    np.testing.assert_array_equal(rec.render_view(-120.0, -10.0, binary=True), bpred)


def test_reconstruction_presets_and_device(run_dirs):
    rec = Reconstruction.from_run_dir(run_dirs["jax"], data_name="LCA", which="coarse",
                                      device="cpu")
    assert rec.eval_config.data_name == "LCA" and rec.eval_config.outside == 80.0
    assert rec.model.config.input_scale == pytest.approx(1 / 80.0)
    assert rec.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Reconstruction.from_run_dir(run_dirs["jax"])
