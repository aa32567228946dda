"""Training CLI (port of ``cli/train.py``): the reference's
``nerf/run_nerf_acc.py`` flag surface (run_nerf_acc.py:25-47) with the JAX
package's protocol knobs, plus ``--device``.

Reads the two datagen CSVs under ``<data_dir>/ct`` (or ``stl/LCA``), trains
the CPPN and writes the run under ``cases/<data_name>/runs/<YYYY-MM-DD-HHMM>/``
(model bundles, grid VTKs, readme.txt, TensorBoard scalars, resume
checkpoints every ``save_every`` iterations).

    python -m nerf_for_angiography_tpu_torch.cli.train --n_iters 20000
    torchrun --standalone --nproc_per_node=N -m nerf_for_angiography_tpu_torch.cli.train ...

Under torchrun each step's ray batch is sharded over the N processes (one
card each, NCCL) and only rank 0 writes the run directory.
"""

from __future__ import annotations

import glob
import os
from datetime import datetime

import torch.distributed as dist

from ..data import load_data
from ..parallel import is_coordinator
from ..training import train
from ..training.config import config_from_args, train_arg_parser
from .common import cli_device, cli_mesh


def main(argv=None):
    """Run the training; returns its TrainResult."""
    a = train_arg_parser().parse_args(argv)
    cfg, data_dir = config_from_args(a)
    device = cli_device(a.device)

    folder = os.path.join(data_dir, "stl/LCA" if cfg.data_name.upper() == "LCA" else "ct")
    proj_csvs = sorted(glob.glob(os.path.join(folder, "df-*toproj.csv")))
    ray_csvs = sorted(glob.glob(os.path.join(folder, "df-rays-*.csv")))
    if not proj_csvs or not ray_csvs:
        raise SystemExit(f"no datagen CSVs under {folder}; run "
                         "python -m nerf_for_angiography_tpu_torch.cli.datagen first")
    print(f"loading {proj_csvs[-1]} + {ray_csvs[-1]}")
    data = load_data(proj_csvs[-1], ray_csvs[-1], device=device)

    mesh = cli_mesh()  # under torchrun: each step's batch sharded over the ranks
    exp_name = [datetime.now().astimezone().strftime("%Y-%m-%d-%H%M")]
    if mesh is not None:  # rank 0's name, on every rank
        dist.broadcast_object_list(exp_name, src=0)
    log_dir = os.path.join("cases", cfg.data_name, "runs", exp_name[0])
    if is_coordinator():
        os.makedirs(log_dir, exist_ok=True)
    print(f"training on {device}, logs -> {log_dir}"
          + (f" (rank {dist.get_rank()} of {dist.get_world_size()})" if mesh is not None else ""))
    result = train(cfg, data.rays, src_pt_z=data.src_pt_z, log_dir=log_dir,
                   rays_per_view=data.rays_per_view, checkpoint_every=cfg.save_every,
                   device=device, mesh=mesh)
    print(f"done: best PSNR {result.best_psnr:.3f} at iter {result.best_iter}, "
          f"{result.rays_per_sec:.0f} rays/s")
    return result


if __name__ == "__main__":
    main()
