"""Port: checkpoints, grid VTK export, logging and resume against the JAX
package: model bundles and grid VTKs read across the two packages, the
CheckpointManager round trip, the artifacts a tiny train(log_dir=...) of
each package writes, resume at the checkpointed step, and the carve guard
(no carve under a warm start or a resume)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
from nerf_for_angiography_tpu.models import init_cppn
from nerf_for_angiography_tpu.ops.occupancy import OccupancyGrid as OccupancyGridJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import load_grid_vtk as load_grid_vtk_j
from nerf_for_angiography_tpu.training import load_model as load_model_j
from nerf_for_angiography_tpu.training import save_grid_vtk as save_grid_vtk_j
from nerf_for_angiography_tpu.training import save_model as save_model_j
from nerf_for_angiography_tpu.training import train as train_j
from nerf_for_angiography_tpu.utils import vtk as vtk_j
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax, cppn_params_to_jax
from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.ops.occupancy import grid_from_numpy
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.training import (
    CheckpointManager,
    ExperimentLogger,
    TrainConfig,
    create_train_state,
    load_grid_vtk,
    load_model,
    make_train_step,
    save_grid_vtk,
    save_model,
    train,
)
from nerf_for_angiography_tpu_torch.utils import vtk as vtk_t

SMALL = dict(compact_samples=0, sample_size=8, depth_samples_per_ray=32, grid_resolution=16,
             num_layers=2, num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3)
SRC_Z = 1500.0


@pytest.fixture(scope="module")
def rays_j():
    """Five 8 x 8 views of the sphere phantom (the held-out one last)."""
    ds = generate_dataset_j(
        make_sphere_volume_j(res=32, extent=75.0, radius=30.0),
        DatagenConfigJ(limited_size=90.0, number_angles=1.0, img_width=8, img_height=8,
                       sample_outside=100.0, stratified_depths=False),
    )
    return jax.tree.map(np.asarray, ds.rays._replace(sampling_table=None))


def _to_torch(r) -> RayDataset:
    return RayDataset(*(None if a is None else torch.from_numpy(np.array(a)) for a in r))


def _pair(pos_enc="none"):
    cfg_j = CPPNConfigJ(num_early_layers=2, num_filters=32, input_scale=0.01, pos_enc=pos_enc)
    model_j, params = init_cppn(cfg_j, jax.random.PRNGKey(5))
    cfg_t = CPPNConfig(num_early_layers=2, num_filters=32, input_scale=0.01, pos_enc=pos_enc)
    return model_j, jax.tree.map(np.asarray, params), cfg_j, cfg_t


# ---------------------------------------------------------------------------
# model bundles and grid VTKs across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos_enc", ["none", "fourier"])
def test_port_bundle_read_by_jax(tmp_path, pos_enc):
    """A port save_model bundle is read by the JAX load_model: the same meta,
    the flax names, and the JAX CPPN on its params agrees with the port CPPN
    within 1e-5 on the same points."""
    model_j, _, cfg_j, cfg_t = _pair(pos_enc)
    model_t = CPPN(cfg_t, generator=torch.Generator().manual_seed(9))
    path = str(tmp_path / "highmodel.npz")
    save_model(path, cfg_t.to_model_definition(), model_t, {"step": 7, "psnr": 21.5})
    meta, params = load_model_j(path)
    assert meta["version"] == "v0.10-tpu"
    assert meta["parameters"] == cfg_j.to_model_definition()
    assert meta["training_information"] == {"step": 7, "psnr": 21.5}
    assert "params/input_layer/kernel" in meta["param_keys"]
    x = np.random.default_rng(0).uniform(-100, 100, (400, 3)).astype(np.float32)
    want = np.asarray(model_j.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos_enc", ["none", "fourier"])
def test_jax_bundle_read_by_port(tmp_path, pos_enc):
    """A JAX save_model bundle is read by the port's load_model; its params
    load into the port CPPN, which agrees with the JAX CPPN within 1e-5."""
    model_j, params, cfg_j, cfg_t = _pair(pos_enc)
    path = str(tmp_path / "coarsemodel.npz")
    save_model_j(path, cfg_j.to_model_definition(), params, {"step": 3})
    meta, loaded = load_model(path)
    assert meta["parameters"] == cfg_t.to_model_definition()
    model_t = CPPN(cfg_t)
    model_t.load_state_dict(cppn_params_from_jax(loaded))
    for name, t in cppn_params_from_jax(params).items():
        assert torch.equal(model_t.state_dict()[name], t), name
    x = np.random.default_rng(1).uniform(-100, 100, (400, 3)).astype(np.float32)
    want = np.asarray(model_j.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_param_conversion_round_trips():
    """cppn_params_to_jax is the inverse of cppn_params_from_jax, bit for
    bit, with the flax shapes (kernel (in, out))."""
    _, params, _, cfg_t = _pair("fourier")
    back = cppn_params_to_jax(cppn_params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _random_binary(res, seed):
    return np.random.default_rng(seed).uniform(size=(res,) * 3) < 0.3


def test_grid_vtk_port_to_jax(tmp_path):
    """Port save_grid_vtk -> JAX load_grid_vtk: the binary grid equal; the
    file is byte for byte what the JAX package writes for the same grid."""
    binary = _random_binary(16, 0)
    aabb = np.array([-100.0] * 3 + [100.0] * 3, np.float32)
    p_t, p_j = str(tmp_path / "port.vtk"), str(tmp_path / "jax.vtk")
    save_grid_vtk(p_t, grid_from_numpy(binary, aabb))
    save_grid_vtk_j(p_j, OccupancyGridJ(occs=jnp.asarray(binary, jnp.float32),
                                        binary=jnp.asarray(binary), aabb=jnp.asarray(aabb)))
    restored = load_grid_vtk_j(p_t, aabb)
    np.testing.assert_array_equal(np.asarray(restored.binary), binary)
    assert open(p_t, "rb").read() == open(p_j, "rb").read()


def test_grid_vtk_jax_to_port(tmp_path):
    """JAX save_grid_vtk -> port load_grid_vtk: binary equal, occs the
    binary as f32 (as the JAX reader), the coarse table rebuilt."""
    binary = _random_binary(32, 1)
    aabb = np.array([-60.0] * 3 + [60.0] * 3, np.float32)
    path = str(tmp_path / "highgrid.vtk")
    save_grid_vtk_j(path, OccupancyGridJ(occs=jnp.zeros((32,) * 3), binary=jnp.asarray(binary),
                                         aabb=jnp.asarray(aabb)))
    g = load_grid_vtk(path, aabb)
    np.testing.assert_array_equal(g.binary.numpy(), binary)
    np.testing.assert_array_equal(g.occs.numpy(), binary.astype(np.float32))
    np.testing.assert_array_equal(g.aabb.numpy(), aabb)
    assert torch.equal(g.coarse, grid_from_numpy(binary, aabb).coarse)
    gj = load_grid_vtk_j(path, aabb)
    np.testing.assert_array_equal(np.asarray(gj.occs), g.occs.numpy())


def test_vtk_module_is_the_jax_one(tmp_path):
    """The port's copy of utils/vtk.py writes and reads what the JAX module
    does: structured points (ASCII and binary) and a structured grid."""
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(4, 5, 6)).astype(np.float32)
    pts = rng.normal(size=(4 * 5 * 6, 3)).astype(np.float32)
    for binary in (False, True):
        for mod, name in ((vtk_t, "t"), (vtk_j, "j")):
            mod.write_structured_points(str(tmp_path / f"sp{name}{binary}.vtk"), vals,
                                        origin=(1.0, 2.0, 3.0), spacing=(0.5, 0.5, 2.0),
                                        binary=binary)
            mod.write_structured_grid(str(tmp_path / f"sg{name}{binary}.vtk"), pts, (4, 5, 6),
                                      {"density": vals.reshape(-1)}, binary=binary)
        for kind in ("sp", "sg"):
            a = open(tmp_path / f"{kind}t{binary}.vtk", "rb").read()
            assert a == open(tmp_path / f"{kind}j{binary}.vtk", "rb").read()
        g = vtk_t.read_vtk(str(tmp_path / f"spj{binary}.vtk"))
        np.testing.assert_allclose(g.scalars_3d("values"), vals, rtol=1e-6)
    np.testing.assert_array_equal(vtk_t.flat_vtk_order(vals), vtk_j.flat_vtk_order(vals))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def _stepped_state(rays_j, n_steps, seed=0):
    cfg = TrainConfig(**SMALL, seed=seed)
    model, state = create_train_state(cfg, device="cpu")
    step = make_train_step(model, cfg, SRC_Z - cfg.outside, SRC_Z + cfg.outside)
    rays = _to_torch(rays_j)
    for _ in range(n_steps):
        state, *_ = step(state, rays)
    return cfg, state


def _state_tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    for gname in ("grid", "vessel_grid"):
        for k, v in getattr(state, gname)._asdict().items():
            if v is not None:
                out[f"{gname}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


def test_checkpoint_manager_restores_bit_equal(tmp_path, rays_j):
    """save -> restore into a fresh state of the same configuration: every
    tensor (parameters, Adam moments and step, both grids with their carve
    masks and coarse tables), the step, the lr schedule and the generator
    state are equal; the restored state then steps exactly as the saved one."""
    cfg, state = _stepped_state(rays_j, 5)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None and mgr.restore(state) is None
    mgr.save(5, state)
    _, fresh = create_train_state(cfg, seed=123, device="cpu")
    restored = mgr.restore(fresh)
    assert restored is fresh and restored.step == state.step == 5
    want, got = _state_tensors(state), _state_tensors(restored)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert restored.scheduler.state_dict() == state.scheduler.state_dict()
    assert restored.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    rays = _to_torch(rays_j)
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    _, m_a, p_a, _ = make_train_step(state.model, cfg, near, far)(state, rays)
    _, m_b, p_b, _ = make_train_step(restored.model, cfg, near, far)(restored, rays)
    assert torch.equal(p_a, p_b)
    for k in state.model.state_dict():
        assert torch.equal(state.model.state_dict()[k], restored.model.state_dict()[k]), k


def test_checkpoint_manager_keeps_the_newest_two(tmp_path, rays_j):
    _, state = _stepped_state(rays_j, 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (10, 20, 30):
        state.step = step
        mgr.save(step, state)
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_20.pt", "ckpt_30.pt"]
    mgr.close()


# ---------------------------------------------------------------------------
# train(log_dir=...): artifacts, resume, the carve guard
# ---------------------------------------------------------------------------


def _artifacts(log_dir) -> set[str]:
    """Top-level names, the TensorBoard event file's host/time suffix cut."""
    return {"events.out.tfevents" if f.startswith("events.out.tfevents") else f
            for f in os.listdir(log_dir)}


@pytest.fixture(scope="module")
def jax_run(rays_j, tmp_path_factory):
    """One tiny JAX train(log_dir, checkpoint_every) and its resume."""
    log_dir = str(tmp_path_factory.mktemp("jax_run"))
    cfg = dict(SMALL, n_iters=20, display_every=10)
    first = train_j(TrainConfigJ(**cfg), rays_j, SRC_Z, log_dir=log_dir, checkpoint_every=10,
                    verbose=False)
    names = _artifacts(log_dir)
    second = train_j(TrainConfigJ(**{**cfg, "n_iters": 30}), rays_j, SRC_Z, log_dir=log_dir,
                     checkpoint_every=10, verbose=False)
    return dict(log_dir=log_dir, names=names, first=first, second=second)


def test_log_dir_writes_the_jax_artifacts(tmp_path, rays_j, jax_run, capsys):
    """Tiny CPU train(log_dir=...) runs of both packages write the same
    artifact names; the port's bundles and grids are read by the JAX
    package's readers, and the bundle holds the best model of the run."""
    log_dir = str(tmp_path / "run")
    res = train(TrainConfig(**SMALL, n_iters=20, display_every=10), _to_torch(rays_j), SRC_Z,
                log_dir=log_dir, checkpoint_every=10, verbose=False, device="cpu")
    assert _artifacts(log_dir) == jax_run["names"]
    assert {"highmodel.npz", "coarsemodel.npz", "highgrid.vtk", "highvesselgrid.vtk",
            "coarsegrid.vtk", "coarsevesselgrid.vtk", "readme.txt", "ckpt"} <= _artifacts(log_dir)
    meta, params = load_model_j(os.path.join(log_dir, "highmodel.npz"))
    assert meta["training_information"]["step"] == res.best_iter
    assert meta["training_information"]["psnr"] == pytest.approx(res.best_heldout_psnr)
    meta_j, _ = load_model_j(os.path.join(jax_run["log_dir"], "highmodel.npz"))
    assert meta["parameters"] == meta_j["parameters"]
    assert set(meta["param_keys"]) == set(meta_j["param_keys"])
    g = load_grid_vtk_j(os.path.join(log_dir, "coarsegrid.vtk"), res.state.grid.aabb.numpy())
    np.testing.assert_array_equal(np.asarray(g.binary), res.state.grid.binary.numpy())
    readme = open(os.path.join(log_dir, "readme.txt")).read()
    assert "Model architecture=2x32" in readme and f"PSNR={res.best_heldout_psnr}" in readme
    assert CheckpointManager(os.path.join(log_dir, "ckpt")).all_steps() == [10, 20]
    assert res.timing["export"] > 0 and res.timing["log"] > 0


def test_resume_prints_the_resumed_step(tmp_path, rays_j, jax_run, capsys):
    """A second train() on the same log_dir resumes from the newest
    checkpoint at state.step (21: the checkpoint at iteration 20 holds 21
    steps), as the JAX loop does, does not carve, and runs iterations
    21..30."""
    log_dir = str(tmp_path / "run")
    cfg = dict(SMALL, n_iters=20, display_every=10)
    rays = _to_torch(rays_j)
    train(TrainConfig(**cfg), rays, SRC_Z, log_dir=log_dir, checkpoint_every=10, device="cpu")
    first = capsys.readouterr().out
    assert "carve_init:" in first and "resumed" not in first
    res = train(TrainConfig(**{**cfg, "n_iters": 30}), rays, SRC_Z, log_dir=log_dir,
                checkpoint_every=10, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 21" in out
    assert "carve_init:" not in out
    assert res.state.step == int(np.asarray(jax_run["second"].state.step)) == 31
    assert int(np.asarray(jax_run["first"].state.step)) == 21
    assert re.findall(r"Iteration: (\d+)", out) == ["30"]
    assert CheckpointManager(os.path.join(log_dir, "ckpt")).all_steps() == [20, 30]


def test_initial_state_is_not_carved(rays_j, capsys):
    """carve_init with an initial_state leaves the grid uncarved (JAX
    loop.py:227-229): the warm-start state trains from its own grid."""
    cfg = TrainConfig(**SMALL, n_iters=10, display_every=10)
    assert cfg.carve_init
    model, st = create_train_state(cfg, device="cpu")
    res = train(cfg, _to_torch(rays_j), SRC_Z, initial_state=st, device="cpu")
    assert "carve_init:" not in capsys.readouterr().out
    assert res.state is st and st.grid.feasible is None and st.vessel_grid.feasible is None
    assert st.step == 11
    # the same run without the warm start carves
    train(cfg, _to_torch(rays_j), SRC_Z, device="cpu")
    assert "carve_init:" in capsys.readouterr().out


def test_logger_writes_the_reference_tags(tmp_path):
    """ExperimentLogger writes TensorBoard events with the reference's tags
    where tensorboardX is installed, and nothing without it."""
    logger = ExperimentLogger(str(tmp_path))
    logger.scalars({"loss/train-pixel-coarse": torch.tensor(0.5)}, 3)
    logger.train_images(np.zeros((4, 4), np.float32), np.ones((4, 4), np.float32), 3)
    logger.close()
    events = [f for f in os.listdir(tmp_path) if f.startswith("events.out.tfevents")]
    assert len(events) == (1 if logger.writer is not None else 0)
