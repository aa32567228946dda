"""A tiny cell for the CPU tests: the harness's own files, with a
BENCHMARK.json, a configuration, a traffic mix and limits of its own in a
temporary directory."""

from __future__ import annotations

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
WORKLOAD = "tiny.train"
# set from the tiny cell's readings on the CPU (seeds 1, 2): the port reads
# loss 1.2e-5 / 1.1e-5, grad 3.6e-3 / 1.6e-3, change 8.4e-3 / 3.6e-3; the
# float8 control 1.2e-4 / 3.6e-5, 4.5e-2 / 4.5e-2, 4.6e-2 / 3.3e-2; pixels
# over seeds 1 to 6 of the training and the pose mix: the port 4.2e-6 at
# most, the control 2.0e-5 at least
LIMITS = {"start": 0.0, "rows": 0.0, "grid": 0.0, "pixels": 1.0e-5, "loss": 3e-5, "grad": 1.5e-2,
          "change": 2e-2, "shifts_grad": 0.0, "shifts_change": 0.0}
TRAIN = {"n_iters": 40, "warmup_iters": 2, "job_seeds": [1, 2], "train": {}, "datagen": {}}
# the pose mix at the tiny size; its limits set from the tiny pose cell's
# readings on the CPU (seeds 1, 2, 3): the port reads shifts_grad up to
# 1.0e-2 and shifts_change up to 3.9e-3; the float8 control shifts_grad
# 8.9e-3 to 0.21 (no separation at this size, so the limit lets the port
# through and the control fails ``grad``), the pose_unchanged fault
# shifts_change 1
POSE = {"n_iters": 40, "warmup_iters": 2, "job_seeds": [1, 2],
        "train": {"pose_refine": True, "pose_lr": 0.01, "pose_weight_decay": 0.001,
                  "pose_start": 0},
        "datagen": {"max_shift_translation": 0.05, "rays_from_nominal": True}}
POSE_LIMITS = {**LIMITS, "shifts_grad": 2e-2, "shifts_change": 5e-2}
# the training mix with the Fourier encoding; the training limits hold it:
# on the CPU (seeds 1 to 8) the port reads pixels up to 4.6e-6, loss 2.2e-5,
# grad 7.7e-3, change 7.7e-3; the float8 control (seeds 1 to 3) at least
# 2.5e-5, 1.3e-4, 2.0e-2, 8.8e-3; the coeff_unchanged fault change 0.32 to
# 0.35 (the coefficients' leaf, 15 entries, moves about sqrt(15 / 128) of
# the median leaf)
FOURIER = {**TRAIN, "train": {"pos_enc": "fourier"}}
# the training mix with BARF's window opening inside the three watched
# steps: alpha 0, 1.25, 2.5 (band 0 closed, half open, open; band 1 half
# open at step 2); on the CPU (seeds 1 to 3) the port reads grad up to
# 1.0e-2 and change 1.0e-2, the control grad 1.8e-2 to 6.8e-2
BARF = {**TRAIN, "train": {"pos_enc": "barf", "barf_start": 0, "barf_stop": 4}}


def tiny_train(**kw) -> dict:
    with open(os.path.join(BENCH, "configs", "ct_vessel.json")) as f:
        train = json.load(f)["train"]
    train.update(sample_size=6, depth_samples_per_ray=48, grid_resolution=16, display_every=20,
                 compact_check_every=20, compact_samples=24, compact_engage_max=40)
    train.update(kw)
    return train


def make_root(tmp: str, traffic: dict | None = None, limits: dict | None = None,
              train: dict | None = None, config: dict | None = None) -> tuple[str, str]:
    """(root, bench) of a tiny cell under ``tmp``; ``config`` in place of
    the tiny configuration (a cell root of another size)."""
    root = os.path.join(tmp, "root")
    bench = os.path.join(root, "portbench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, d), exist_ok=True)
    os.symlink(os.path.join(BENCH, "metrics"), os.path.join(bench, "metrics"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"] = [{"name": "tiny", "source": "a tiny phantom run",
                            "file": "portbench/configs/tiny.json", "reduced": [], "why": "tests"}]
    manifest["workloads"] = [{"name": WORKLOAD, "config": "tiny", "traffic": "tiny", "chips": 1,
                              "why": "tests"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [WORKLOAD]
    config = config or {
        "name": "tiny", "volume": {"make": "make_vessel_volume", "res": 24},
        "datagen_make": "DatagenConfig",
        "datagen": {"limited_size": 180.0, "number_angles": 1.0, "img_width": 12,
                    "img_height": 12, "sample_outside": 100.0, "stratified_depths": False},
        "train": train or tiny_train()}
    traffic = traffic or TRAIN
    limits = limits or LIMITS
    files = {"BENCHMARK.json": manifest, "portbench/configs/tiny.json": config,
             "portbench/traffic/tiny.json": traffic,
             f"portbench/limits/{WORKLOAD}.json": {"limits": limits}}
    for rel, obj in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    return root, bench
