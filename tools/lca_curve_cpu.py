#!/usr/bin/env python3
"""The LCA protocol's early held-out PSNR curve in both packages on the CPU,
at a size both can run, on the same configuration and seeds: whether the
port's early-curve gap to the JAX LCA anchor shows there too.

    python3 tools/lca_curve_cpu.py [--iters 1000] [--seeds 0,1,2,3]

Runs itself once a package (``--package jax`` / ``--package torch``, the two
at once), so no process imports both. Each makes the LCA dataset with its own package from
``sdf_datagen_config()`` (the two packages' images agree within 3e-5,
tests/test_torch_sdf.py), then runs ``train()`` at the
LCA anchor's configuration (``compact_engage_max=192``, ``data_name='LCA'``,
the source at z = 4000) with the cuts of CUTS, recording the held-out PSNR
at every eval (every EVERY iterations). Prints each seed's curve, then each
eval's mean over the seeds in both packages side by side. The report goes
to ``smoke_out/lca_curve_cpu.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the anchor's batch of 75 x 75 rays and 4 x 128 MLP cut for the CPU; the
# views, depth samples (300), grid, learning rates and schedules unchanged
CUTS = dict(sample_size=25, num_hidden_units=64)
EVERY = 100


def run_jax(seeds: list[int], iters: int) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import numpy as np

    from nerf_for_angiography_tpu.data import generate_dataset, make_lca_sdf_volume
    from nerf_for_angiography_tpu.data.datasets import sdf_datagen_config
    from nerf_for_angiography_tpu.training import TrainConfig, train
    from nerf_for_angiography_tpu.training import loop

    dcfg = sdf_datagen_config()
    ds = generate_dataset(make_lca_sdf_volume(), dcfg)
    src_z = float(np.asarray(dcfg.src_pt)[2])
    out = {}
    for seed in seeds:
        cfg = TrainConfig(compact_engage_max=192, data_name="LCA", display_every=EVERY,
                          n_iters=iters, seed=seed, **CUTS)
        out[seed] = recorded_run(loop, lambda: train(cfg, ds.rays, src_z, verbose=False))
    return out


def run_torch(seeds: list[int], iters: int) -> dict:
    from nerf_for_angiography_tpu_torch.data import generate_dataset, make_lca_sdf_volume
    from nerf_for_angiography_tpu_torch.data.datasets import sdf_datagen_config
    from nerf_for_angiography_tpu_torch.training import lca_protocol, loop, train

    ds = generate_dataset(make_lca_sdf_volume(),
                          sdf_datagen_config(), device="cpu")
    out = {}
    for seed in seeds:
        cfg, src_z = lca_protocol(display_every=EVERY, n_iters=iters, seed=seed, **CUTS)
        out[seed] = recorded_run(
            loop, lambda: train(cfg, ds.rays, src_pt_z=src_z, verbose=False, device="cpu"))
    return out


def recorded_run(loop, fn) -> dict:
    """fn() (a train() call) with every held-out eval of the package's
    training ``loop`` module recorded (chip_smoke.recorded_evals)."""
    from chip_smoke import recorded_evals

    with recorded_evals(loop) as evals:
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
    return dict(evals=evals, best=float(res.best_heldout_psnr), best_iter=int(res.best_iter),
                wall_s=wall)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--package", choices=("jax", "torch"), default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    sys.path.insert(0, ROOT)
    if args.package:
        fn = run_jax if args.package == "jax" else run_torch
        print(json.dumps(fn(seeds, args.iters)))
        return 0
    report = {"cuts": CUTS, "every": EVERY, "iters": args.iters}
    procs = {pkg: subprocess.Popen([sys.executable, __file__, "--package", pkg, "--iters",
                                    str(args.iters), "--seeds", args.seeds],
                                   stdout=subprocess.PIPE, text=True)
             for pkg in ("jax", "torch")}
    for pkg, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"the {pkg} run failed ({proc.returncode})")
        report[pkg] = json.loads(out.strip().splitlines()[-1])
        for seed, r in report[pkg].items():
            print(f"{pkg} seed {seed}: held-out PSNR by eval "
                  f"{[(i, round(p, 3)) for i, p, _ in r['evals']]}; best {r['best']:.3f} dB at "
                  f"{r['best_iter']}; {r['wall_s']:.0f} s", flush=True)
    print("iteration: mean held-out PSNR over the seeds, jax / torch (dB)")
    for j, (it, *_) in enumerate(report["jax"][str(seeds[0])]["evals"]):
        m = [sum(r["evals"][j][1] for r in report[p].values()) / len(seeds)
             for p in ("jax", "torch")]
        print(f"{it}: {m[0]:.3f} / {m[1]:.3f}")
    os.makedirs(os.path.join(ROOT, "smoke_out"), exist_ok=True)
    with open(os.path.join(ROOT, "smoke_out", "lca_curve_cpu.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
