#!/usr/bin/env python3
"""The LCA protocol's held-out PSNR under variants of its configuration,
to locate where the port's LCA quality parts from the JAX anchor's.

    python3 tools/torch_lca_variants.py [--iters 8000] [--only base,no_carve]

Needs an NVIDIA GPU. Builds the LCA dataset at full size
(``make_lca_sdf_volume()`` through ``sdf_datagen_config()``) once, then runs
``train()`` for each variant of the anchor's configuration
(``training.lca_protocol``) in turn, and prints one line a
variant: the held-out PSNR at every eval, the best-checkpoint held-out PSNR
and its iteration, the steady rate and the Tunings. The report goes to
``smoke_out/lca_variants.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"

# the anchor's configuration and one change each
VARIANTS = {
    "base": {},
    "no_carve": {"carve_init": False},  # dense until the grid prunes (the r3 anchor)
    "dense": {"compact_samples": 0},  # no compacted march at all
    "seed1": {"seed": 1},  # other seeds of the base
    "seed2": {"seed": 2},
    "seed3": {"seed": 3},
    "gumbel": {"sampling_impl": "gumbel"},  # the exact weighted sampler
    "random": {"sampling_strategy": "random"},  # uniform ray draws
}


def run(torch, ds, name: str, overrides: dict, iters: int) -> dict:
    from chip_smoke import recorded_evals
    from nerf_for_angiography_tpu_torch.training import lca_protocol, train

    cfg, src_z = lca_protocol(n_iters=iters, **overrides)
    with recorded_evals() as evals:
        t0 = time.perf_counter()
        res = train(cfg, ds.rays, src_pt_z=src_z, verbose=False, device=DEVICE)
        wall = time.perf_counter() - t0
    phases = [(p["mode"], p["k"], p["w_cap"], p["w_lo"], p["k_lo"], p["steps"])
              for p in res.timing["steady_phases"]]
    out = dict(name=name, overrides=overrides, iters=iters, evals=evals,
               best_heldout_psnr=res.best_heldout_psnr, best_iter=res.best_iter,
               best_vessel_psnr=res.best_psnr, last_psnr=res.last_psnr,
               steady_rays_per_sec=res.timing["steady_rays_per_sec"], wall_s=wall,
               pressure_fired=res.timing["pressure_fired"], phases=phases)
    print(f"{name} {overrides}: held-out PSNR by eval "
          f"{[(i, round(p, 3)) for i, p, _ in evals]}; best {res.best_heldout_psnr:.3f} dB at "
          f"{res.best_iter} (vessel {res.best_psnr:.3f}); steady "
          f"{res.timing['steady_rays_per_sec']:.0f} rays/s, {wall:.1f} s; pressure fired "
          f"{res.timing['pressure_fired']}; Tunings (mode, k, w_cap, w_lo, k_lo, steps) {phases}",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--only", default=None, help="comma-separated variant names")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nerf_for_angiography_tpu_torch.data import generate_dataset, make_lca_sdf_volume
    from nerf_for_angiography_tpu_torch.data.datasets import sdf_datagen_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    ds = generate_dataset(make_lca_sdf_volume(), sdf_datagen_config(), device="cuda")
    names = args.only.split(",") if args.only else list(VARIANTS)
    report = {"nvidia_smi": smi, "variants": [run(torch, ds, n, VARIANTS[n], args.iters)
                                              for n in names]}
    os.makedirs(os.path.join(ROOT, "smoke_out"), exist_ok=True)
    with open(os.path.join(ROOT, "smoke_out", "lca_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
