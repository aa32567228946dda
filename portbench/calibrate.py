"""Readings that the output check's limits are set from (not run by the
benchmark's own runs).

    python3 -m portbench.calibrate --workload ct_vessel.train --seeds 101 102 103 \
        --modes program control unchanged half_batch answer

``--root`` takes a cell from a root of its own (a ``BENCHMARK.json`` and
``portbench/`` directories of configurations, traffic and limits, as
portbench/tests/tiny.py::make_root builds one) in place of the checkout's.

For each seed and mode, a reconstruction of the cell's settings is run for
its first three steps alone (``n_iters=2``: the same steps, chunks and
graphs as a whole job's first three) and held against the plain reference,
as a benchmark run holds its first job:

- ``program``: the port as it is (the lower readings);
- ``control``: the reference in float8 put in the port's place (the upper
  readings);
- ``unchanged``, ``half_batch``, ``answer``, ``pose_unchanged``,
  ``coeff_unchanged``: the port with a fault planted (portbench/faults.py).

Prints one JSON line a reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def reading(torch, workload: str, seed: int, mode: str, rays, src_z, train: dict,
            device) -> dict:
    from nerf_for_angiography_tpu_torch.training import TrainConfig, graph, loop

    from . import check, faults
    from .reference import steps as reference

    spec = check.reference_spec(train, src_z)
    inputs = {k: getattr(rays, k) for k in ("origins", "directions", "pixel_values", "weights",
                                             "image_ids")}
    if mode == "control":
        obs = faults.observed(reference.follow(spec, inputs, seed, check.N_STEPS,
                                               quant=reference.fp8_quant))
    else:
        tap = check.StepTap(graph.TrainChunk)
        plant = faults.FAULTS[mode] if mode != "program" else contextlib.nullcontext
        cfg = TrainConfig(**{**train, "seed": int(seed), "n_iters": check.N_STEPS - 1})
        with plant(), tap, contextlib.redirect_stdout(sys.stderr):
            loop.train(cfg, rays, src_z, log_dir=None, device=device)
        obs = tap.obs
    ref = reference.follow(spec, inputs, seed, check.N_STEPS)
    numbers = check.compare(obs, ref)
    return {"workload": workload, "seed": seed, "mode": mode, **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program", "control"])
    p.add_argument("--out", default=None)
    p.add_argument("--root", default=None)
    a = p.parse_args(argv)
    from . import run

    run.set_cache_dirs()
    import torch

    spec = (run.load_cell(a.workload, a.root, os.path.join(a.root, "portbench")) if a.root
            else run.load_cell(a.workload))
    dev = torch.device("cuda")
    out = []
    _, datagen, _ = run.settings(spec["config"], spec["traffic"], 0)
    rays, src_z = run.make_dataset(torch, spec["config"], datagen, dev)
    for seed in a.seeds:
        train, _, _ = run.settings(spec["config"], spec["traffic"], seed)
        for mode in a.modes:
            r = reading(torch, a.workload, seed, mode, rays, src_z, train, dev)
            print(json.dumps(r), flush=True)
            out.append(r)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
