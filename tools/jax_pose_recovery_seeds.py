#!/usr/bin/env python3
"""The JAX package's pose-recovery test (tests/test_training.py:352-425)
over several training keys, on the CPU: how often one run meets the test's
two thresholds on the in-plane residuals.

    JAX_PLATFORMS=cpu python tools/jax_pose_recovery_seeds.py 0 1 2 3 4 5 6 7

The dataset is the test's (PRNGKey(5)); each key seeds create_train_state
(weights and the sampling key). About five minutes a key on one CPU core.
"""

import sys

import jax
import numpy as np

from nerf_for_angiography_tpu.data import DatagenConfig, generate_dataset, make_vessel_volume
from nerf_for_angiography_tpu.training import TrainConfig, create_train_state, make_train_step


def main(keys: list[int]) -> None:
    dcfg = DatagenConfig(limited_size=90.0, number_angles=1.0, img_width=24, img_height=24,
                         sample_outside=100.0, stratified_depths=False,
                         max_shift_translation=0.05, rays_from_nominal=True)
    ds = generate_dataset(make_vessel_volume(res=48), dcfg, key=jax.random.PRNGKey(5))
    gt = np.stack([np.asarray(ds.proj[f"translation_{c}"]) for c in "xyz"], axis=-1)
    n_views = gt.shape[0]
    dirs = np.asarray(ds.rays.directions).reshape(n_views, 24 * 24, 3)
    d_c = dirs[:, 12 * 24 + 12]
    d_c = d_c / np.linalg.norm(d_c, axis=-1, keepdims=True)
    proj = np.eye(3)[None] - d_c[:, :, None] * d_c[:, None, :]

    def inplane(learned):
        r = learned - gt
        rhs = np.einsum("vij,vj->vi", proj, r)
        g, *_ = np.linalg.lstsq(proj.reshape(-1, 3), rhs.reshape(-1), rcond=None)
        return np.linalg.norm(np.einsum("vij,vj->vi", proj, r - g[None]), axis=-1)

    e0 = inplane(np.zeros_like(gt))
    cfg = TrainConfig(depth_samples_per_ray=32, sample_size=24, grid_resolution=8,
                      outside=100.0, display_every=50, n_iters=900, early_stop_iters=10_000,
                      coarse_lr=2e-3, pose_refine=True, pose_lr=3e-2, pose_start=200,
                      grid_update_every=100_000)
    for key in keys:
        model, state = create_train_state(cfg, jax.random.PRNGKey(key), num_views=n_views)
        step = make_train_step(model, cfg, near=1400.0, far=1600.0)
        for _ in range(cfg.n_iters):
            state, _, _, _ = step(state, ds.rays)
        e = inplane(np.asarray(state.params["params"]["view_shifts"]))
        print(f"key {key}: mean ratio {e.mean() / e0.mean():.4f} (limit 0.4), every view "
              f"below 0.8 e0 + 0.05: {bool((e < 0.8 * e0 + 0.05).all())}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [0])
