#!/usr/bin/env python3
"""The classic coarse-to-fine path of the JAX package and of the port side by
side on the CPU, at full model width (TrainConfig()'s 4x128 CPPN, 300 coarse
+ 64 fine samples a ray) on the smoke's vessel phantom (26 views of
100x100), with a smaller batch: whether each package's field learns more
than the transparent background at a given lr. Both start from the same
weights (the JAX init copied across); each draws its own batches.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/classic_lr_cpu.py --lr 5e-3 1e-3 1e-4 --steps 300

Prints, per package and lr, the mean fine loss of each 10 steps over an
empty field's loss on the weighted batches (about 1.0: the field is
transparent; well below: it holds the vessels). About 1.5 s a step for the
two packages at the default 24^2 rays.
"""

import argparse
import statistics

import jax
import numpy as np
import torch

from nerf_for_angiography_tpu.data import DatagenConfig, generate_dataset, make_vessel_volume
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training.classic import (
    create_classic_state as create_classic_state_j,
)
from nerf_for_angiography_tpu.training.classic import (
    make_classic_train_step as make_classic_train_step_j,
)
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    create_classic_state,
    create_train_state,
    make_classic_train_step,
)

SRC_Z, N_FINE, WINDOW = 1500.0, 64, 10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[5e-3, 1e-4])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--sample-size", type=int, default=24, help="rays a batch: its square")
    args = ap.parse_args()
    ds = generate_dataset(
        make_vessel_volume(res=96),
        DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=100, img_height=100,
                      sample_outside=100.0, stratified_depths=False),
        key=jax.random.PRNGKey(0))
    rays_j = ds.rays
    fields = {f: np.asarray(getattr(rays_j, f)) for f in RayDataset._fields
              if f != "sampling_table"}
    rays_t = RayDataset(**{
        f: torch.from_numpy(v.astype(np.int64 if v.dtype.kind == "i" else v.dtype))
        for f, v in fields.items()})
    px, w = fields["pixel_values"].astype(np.float64), fields["weights"].astype(np.float64)
    empty = float(((1.0 - px) ** 2 * w).sum() / w.sum())
    for lr in args.lr:
        kw = dict(coarse_lr=lr, sample_size=args.sample_size)
        cfg_j, cfg_t = TrainConfigJ(**kw), TrainConfig(**kw)
        near, far = SRC_Z - cfg_t.outside, SRC_Z + cfg_t.outside
        model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
        cstate = create_classic_state_j(model_j, state_j.params, cfg_j, jax.random.PRNGKey(1))
        step_j = make_classic_train_step_j(model_j, cfg_j, near, far, n_fine=N_FINE)
        model_t, _ = create_train_state(cfg_t, device="cpu")
        model_t.load_state_dict(cppn_params_from_jax(jax.tree.map(np.asarray, state_j.params)))
        state_t = create_classic_state(model_t, cfg_t, device="cpu")
        step_t = make_classic_train_step(model_t, cfg_t, near, far, n_fine=N_FINE)
        losses = {"jax": [], "port": []}
        for _ in range(args.steps):
            cstate, m = step_j(cstate, rays_j)
            losses["jax"].append(float(m["loss/train-pixel-fine"]))
            state_t, m = step_t(state_t, rays_t)
            losses["port"].append(float(m["loss/train-pixel-fine"]))
        for pkg, ls in losses.items():
            windows = [statistics.fmean(ls[i:i + WINDOW]) / empty
                       for i in range(0, len(ls) - WINDOW + 1, WINDOW)]
            print(f"lr {lr} {pkg}: {args.sample_size ** 2} rays x (300 + {N_FINE}), fine loss "
                  f"{ls[0]:.6f} -> {ls[-1]:.6f} (an empty field's {empty:.6f}); the mean of each "
                  f"{WINDOW} steps over it {[round(v, 4) for v in windows]}", flush=True)


if __name__ == "__main__":
    main()
