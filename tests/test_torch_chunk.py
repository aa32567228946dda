"""Port: the chunked train step (the JAX make_train_chunk) on the CPU. The
device lr against optax's exponential_decay, the device BARF alpha against
the JAX schedule, a step sequence across a dense grid update and two slabs
against the JAX step on injected batches (grids written in place),
make_train_chunk against the same number of eager steps bit for bit, and
the chunk's pressure reduction against the JAX loop's _pressure_stats."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.models import barf_alpha_schedule as barf_alpha_schedule_j
from nerf_for_angiography_tpu.ops.sampling import RayBatch as RayBatchJ
from nerf_for_angiography_tpu.ops.sampling import RayDataset as RayDatasetJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training.loop import _PRESSURE_KEYS as PRESSURE_KEYS_J
from nerf_for_angiography_tpu.training.loop import _pressure_stats
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.models import barf_alpha_device
from nerf_for_angiography_tpu_torch.ops.occupancy import coarse_dilated_grid, grid_update_kind
from nerf_for_angiography_tpu_torch.ops.sampling import RayBatch
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    copy_state,
    create_train_state,
    make_train_chunk,
    make_train_step,
)
from nerf_for_angiography_tpu_torch.training.train import PRESSURE_KEYS, barf_alpha_of

# the module (the package's ``train`` attribute is the function)
tj = importlib.import_module("nerf_for_angiography_tpu.training.train")

NEAR, FAR = 1400.0, 1600.0
SMALL = dict(
    compact_samples=0, sample_size=8, depth_samples_per_ray=32, grid_resolution=16,
    num_layers=2, num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
)


@pytest.fixture(scope="module")
def rays64():
    ds = generate_dataset_j(
        make_sphere_volume_j(res=32, extent=75.0, radius=30.0),
        DatagenConfigJ(limited_size=90.0, number_angles=1.0, img_width=8, img_height=8,
                       sample_outside=100.0, stratified_depths=False),
    )
    return jax.tree.map(lambda a: np.asarray(a)[:64], ds.rays._replace(sampling_table=None))


def _ulps(a: np.float32, b: np.float32) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("step", [0, 1, 777, 20_000])
def test_device_lr_matches_optax(step):
    """The lr the port's Adam reads at ``step`` is optax's
    exponential_decay(staircase=False) at count ``step`` (the JAX
    make_optimizer's schedule), within one f32 ulp."""
    cfg = TrainConfig(**SMALL)
    sched = optax.exponential_decay(init_value=cfg.coarse_lr, transition_steps=cfg.decay_steps,
                                    decay_rate=cfg.decay_rate, staircase=False)
    want = np.float32(sched(jnp.asarray(step, jnp.int32)))
    _, state = create_train_state(cfg, device="cpu")
    state.step = step
    state.scheduler.apply(state.step_dev)
    got = state.optimizer.param_groups[0]["lr"]
    assert got.dtype == torch.float32 and got.shape == ()
    assert _ulps(got.item(), want) <= 1, (got.item(), float(want))


@pytest.mark.parametrize("step", [0, 49, 50, 51, 123, 299, 300, 301, 5000])
def test_device_barf_alpha_matches_jax(step):
    """The device BARF alpha equals the JAX barf_alpha_schedule bit for bit
    below, inside and past the ramp, and equals the port's host schedule."""
    got = barf_alpha_device(torch.tensor(step, dtype=torch.int32), 5, 50, 300)
    want = np.float32(barf_alpha_schedule_j(step, 5, 50, 300))
    assert got.dtype == torch.float32
    assert got.item() == float(want)
    cfg = TrainConfig(pos_enc="barf", pos_enc_basis=5, barf_start=50, barf_stop=300)
    assert barf_alpha_of(cfg, torch.tensor(step, dtype=torch.int32)).item() == float(want)


@pytest.mark.parametrize("step", [0, 7_999, 8_001, 123_457, 250_000, 260_000])
def test_device_barf_alpha_at_the_shipped_ramp(step):
    cfg = TrainConfig(pos_enc="barf")
    want = np.float32(barf_alpha_schedule_j(step, cfg.pos_enc_basis, cfg.barf_start,
                                            cfg.barf_stop))
    assert barf_alpha_of(cfg, torch.tensor(step, dtype=torch.int32)).item() == float(want)


def _with_schedule_count(opt_state, count: int):
    """The JAX optimizer state with its lr schedule's count set (Adam's own
    count, which sets the bias correction, is kept)."""
    return tuple(
        s._replace(count=jnp.asarray(count, jnp.int32))
        if isinstance(s, optax.ScaleByScheduleState) else s
        for s in opt_state
    )


def test_step_sequence_across_grid_kinds_matches_jax(rays64, monkeypatch):
    """Steps at 240 (a dense grid update), 255 (none), 256 (slab 0, the end
    of the warm-up) and 272 (slab 1) through the port's step_core and the
    JAX step, each on an injected batch with the JAX weights and grids
    copied in first: the port writes the grids into its own tensors, and
    the loss, pixels, grids and new weights agree with the tolerances of
    the single-step test."""
    cfg_j = TrainConfigJ(**SMALL, mlp_backend="xla", compute_dtype="bfloat16")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    step_j = tj._build_train_step(model_j, cfg_j, NEAR, FAR)
    cfg_t = TrainConfig(**SMALL)
    model_t, state_t = create_train_state(cfg_t, device="cpu")
    step_t = make_train_step(model_t, cfg_t, NEAR, FAR)
    ptrs = [t.data_ptr() for g in (state_t.grid, state_t.vessel_grid) for t in g
            if t is not None]
    rng = np.random.default_rng(0)
    kinds = []
    for step in (240, 255, 256, 272):
        kinds.append(grid_update_kind(step, cfg_t.grid_resolution, cfg_t.grid_update_every,
                                      cfg_t.grid_update_slabs))
        perm = rng.permutation(64)
        batch = RayBatchJ(*(jnp.asarray(np.asarray(a)[perm]) for a in
                            (rays64.origins, rays64.directions, rays64.pixel_values,
                             rays64.image_ids)))
        monkeypatch.setattr(tj, "sample_pixel_rays", lambda *a, b=batch, **k: b)
        state_j = state_j._replace(step=jnp.asarray(step, jnp.int32),
                                   opt_state=_with_schedule_count(state_j.opt_state, step))
        # the JAX weights and grids into the port's own tensors
        model_t.load_state_dict(cppn_params_from_jax(jax.tree.map(np.asarray, state_j.params)))
        for g_t, g_j in ((state_t.grid, state_j.grid), (state_t.vessel_grid, state_j.vessel_grid)):
            g_t.occs.copy_(torch.from_numpy(np.array(g_j.occs)))
            g_t.binary.copy_(torch.from_numpy(np.array(g_j.binary)))
            g_t.coarse.copy_(coarse_dilated_grid(g_t.binary, g_t.coarse_factor)[0])
        state_t.step = step
        state_j, metrics_j, pix_j, _ = step_j(state_j, RayDatasetJ(*rays64))
        batch_t = RayBatch(*(torch.from_numpy(np.array(a)) for a in batch))
        state_t, metrics_t, pix_t, _ = step_t.step_core(state_t, batch_t)

        assert state_t.step == int(state_j.step) == step + 1
        assert int(state_t.step_dev) == step + 1
        lr = state_t.optimizer.param_groups[0]["lr"]
        assert lr.item() == state_t.scheduler.value(torch.tensor(step)).item()
        loss_t = float(metrics_t["loss/train-pixel-coarse"])
        assert loss_t == pytest.approx(float(metrics_j["loss/train-pixel-coarse"]), rel=2e-2)
        np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), atol=2e-2)
        for g_t, g_j in ((state_t.grid, state_j.grid), (state_t.vessel_grid, state_j.vessel_grid)):
            np.testing.assert_array_equal(g_t.binary.numpy(), np.asarray(g_j.binary))
        new_j = cppn_params_from_jax(jax.tree.map(np.asarray, state_j.params))
        for name, p in model_t.state_dict().items():
            np.testing.assert_allclose(p.numpy(), new_j[name].numpy(), atol=2 * cfg_t.coarse_lr)
    assert kinds == ["dense", None, 0, 1]
    # every update went into the grids' own tensors
    assert ptrs == [t.data_ptr() for g in (state_t.grid, state_t.vessel_grid) for t in g
                    if t is not None]


@pytest.fixture(scope="module")
def vessel_rays():
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig,
        generate_dataset,
        make_vessel_volume,
    )

    ds = generate_dataset(
        make_vessel_volume(res=24),
        DatagenConfig(limited_size=90.0, number_angles=1.0, img_width=12, img_height=12,
                      sample_outside=100.0, stratified_depths=False),
        device="cpu",
    )
    return ds.rays


def _tensors(state) -> dict:
    out = {f"param/{n}": p for n, p in state.model.named_parameters()}
    opt = state.optimizer
    for i, p in enumerate(opt.param_groups[0]["params"]):
        for k, v in opt.state[p].items():
            out[f"adam/{i}/{k}"] = v
    out["lr"] = opt.param_groups[0]["lr"]
    for name in ("grid", "vessel_grid"):
        for k, v in getattr(state, name)._asdict().items():
            if v is not None:
                out[f"{name}/{k}"] = v
    out["generator"] = state.generator.get_state()
    out["step_dev"] = state.step_dev
    return out


CHUNK_CFGS = {
    "dense": dict(compact_samples=0),
    "lattice": dict(compact_samples=8, march_mode="lattice"),
    "barf": dict(compact_samples=0, pos_enc="barf", barf_start=0, barf_stop=40),
}


def _chunk_against_eager(vessel_rays, kind: str, steps: int | None) -> None:
    """A call of make_train_chunk(n=5) for ``steps`` steps (None: all five)
    from step 14 against as many eager steps from a copy of the state."""
    cfg = TrainConfig(**{**SMALL, "sampling_strategy": "frangi", **CHUNK_CFGS[kind]})
    model, state = create_train_state(cfg, device="cpu")
    state.step = 14
    eager = copy_state(state)
    assert all(a is not b for a, b in zip(_tensors(state).values(), _tensors(eager).values()))
    chunk = make_train_chunk(model, cfg, NEAR, FAR, 5)
    _, m_c, p_c, t_c = chunk(state, vessel_rays, steps)
    step = make_train_step(eager.model, cfg, NEAR, FAR)
    n = 5 if steps is None else steps
    for _ in range(n):
        _, m_e, p_e, t_e = step(eager, vessel_rays)
    assert state.step == eager.step == 14 + n and chunk.captures == 0
    got, want = _tensors(state), _tensors(eager)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert m_c.keys() == m_e.keys()
    for k in m_c:
        assert torch.equal(m_c[k], m_e[k]), k
    assert torch.equal(p_c, p_e) and torch.equal(t_c, t_e)


@pytest.mark.parametrize("kind", sorted(CHUNK_CFGS))
def test_cpu_chunk_equals_eager_steps(vessel_rays, kind):
    """make_train_chunk(n=5) on the CPU equals five eager steps from a copy
    of the same state bit for bit (parameters, Adam state, lr, grids,
    generator, step counters, the last step's metrics and pixels), across a
    grid update at step 16."""
    _chunk_against_eager(vessel_rays, kind, None)


@pytest.mark.parametrize("kind", ["dense", "lattice"])
def test_cpu_partial_chunk_equals_eager_steps(vessel_rays, kind):
    """A call of the chunk for fewer steps (the loop's partial chunk: three
    of five, across the grid update at step 16) equals as many eager steps
    bit for bit."""
    _chunk_against_eager(vessel_rays, kind, 3)


def test_chunk_pressure_is_the_jax_pressure_stats(vessel_rays):
    """The chunk's running max of the steps' truncation pressure equals the
    JAX loop's _pressure_stats of the stacked per-step metrics, and a new
    call starts it again."""
    cfg = TrainConfig(**{**SMALL, **CHUNK_CFGS["lattice"]})
    model, state = create_train_state(cfg, device="cpu")
    chunk = make_train_chunk(model, cfg, NEAR, FAR, 6)
    seen = []
    one = chunk.step

    def recording(st, rays):
        out = one(st, rays)
        seen.append({k: out[1][k].clone() for k in PRESSURE_KEYS})
        return out

    chunk.step = recording
    assert PRESSURE_KEYS == PRESSURE_KEYS_J
    for _ in range(2):
        seen.clear()
        chunk(state, vessel_rays)
        stacked = {k: jnp.asarray(np.stack([s[k].numpy() for s in seen])) for k in PRESSURE_KEYS}
        want = np.asarray(_pressure_stats(stacked))
        assert chunk.pressure.dtype == torch.int32
        np.testing.assert_array_equal(chunk.pressure.numpy(), want)
        assert want[0] > 0 and want[3] > cfg.compact_samples  # k truncates every step here
    assert len(seen) == 6


def test_copy_state_does_not_share(vessel_rays):
    """copy_state: a step on the copy leaves the original as it was."""
    cfg = TrainConfig(**SMALL)
    model, state = create_train_state(cfg, device="cpu")
    make_train_step(model, cfg, NEAR, FAR)(state, vessel_rays)  # the Adam state exists
    before = {k: v.clone() for k, v in _tensors(state).items()}
    dup = copy_state(state)
    make_train_step(dup.model, cfg, NEAR, FAR)(dup, vessel_rays)
    assert dup.step == 2 and state.step == 1
    for k, v in _tensors(state).items():
        assert torch.equal(v, before[k]), k
    assert dataclasses.is_dataclass(dup)
