"""The benchmark of the PyTorch/CUDA port: one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload ct_vessel.train --seed 12345 --seconds 15 --trace 0

Run from the root of a checkout, on a machine with the card(s) the cell asks
for. The harness is driven by data: the cell names a configuration
(``portbench/configs/<config>.json``: the dataset recipe and the training
settings), a traffic mix (``portbench/traffic/<traffic>.json``: the job's
length and its changes to the settings and the dataset) and its metrics,
each read by ``portbench/metrics/<name>.py``; the limits of its output check
sit in ``portbench/limits/<workload>.json``. A configuration names the
port's volume maker and datagen settings maker by name (``volume.make``,
``datagen_make``); a cell whose settings the plain reference does not follow
(portbench/reference/steps.py::unmodelled) is refused before any work.

Set-up (``setup_s``, from the process's start): torch and the CUDA context,
the cell's dataset made on the card, one short reconstruction of the
cell's settings that loads (in a fresh checkout: builds, into
``portbench/build/``) the kernel libraries and warms every shape a job uses.
The window: whole reconstructions back to back, each one call of the port's
``training.loop.train``. The traffic lists the jobs' training seeds
(``job_seeds``); ``--seed`` orders them, so every run does the same work.
The window opens as the first job starts and closes at the end of the first
round of the list that ends at or after ``--seconds``. After it: the peak
memory; with ``--trace 1`` the profiled steps (portbench/steps_profile.py);
then the program's state is freed and the plain reference follows each
job's first steps (portbench/check.py).
The jobs' progress goes to standard error; the last line of standard output
is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import sys
import time

_T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names the process may not hold once the window has closed
JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "optax", "nerf_for_angiography_tpu"})


def process_age() -> float:
    """Seconds since this process started (/proc), else since this module
    was first run."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "portbench", "build")
    os.environ["NERF_ANGIO_BUILD_DIR"] = build
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT, bench: str = HERE) -> dict:
    """The cell's entry, configuration, traffic and metric entries
    (``BENCHMARK.json`` and the configuration files under ``root``; the
    traffic mixes under ``bench``)."""
    manifest = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if workload in m.get("workloads", [])
             or (not m.get("workloads") and m["moves"] in reported)]
    spec = dict(
        cell=cell, end_to_end=e2e, per_layer=layer,
        config=_read_json(os.path.join(root, conf["file"])),
        traffic=_read_json(os.path.join(bench, "traffic", f"{cell['traffic']}.json")),
    )
    from .reference import steps as reference

    train, _, _ = settings(spec["config"], spec["traffic"], 0)
    if unknown := reference.unmodelled(train):
        raise SystemExit(f"{workload}: the plain reference does not follow "
                         + "; ".join(unknown))
    return spec


def read_metrics(entries: list[dict], ctx: dict, bench: str = HERE) -> dict:
    """{name: {value, unit}} of every metric whose reader finds a value."""
    out = {}
    for m in entries:
        path = os.path.join(bench, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def settings(config: dict, traffic: dict, seed: int) -> tuple[dict, dict, int]:
    """(training settings, datagen settings, n_iters) of the cell."""
    train = {**config["train"], **traffic.get("train", {}), "seed": int(seed)}
    datagen = {**config["datagen"], **traffic.get("datagen", {})}
    return train, datagen, int(traffic["n_iters"])


def job_seeds(traffic: dict, seed: int) -> list[int]:
    """The training seeds of one round of jobs: the traffic's list, in an
    order drawn from ``seed``."""
    seeds = [int(s) for s in traffic["job_seeds"]]
    return random.Random(int(seed)).sample(seeds, len(seeds))


def make_dataset(torch, config: dict, datagen: dict, device):
    """The cell's dataset on the device: (RayDataset, src_pt_z), from the
    port's volume maker ``config["volume"]["make"]`` (its other keys are the
    maker's arguments) and datagen settings maker ``config["datagen_make"]``
    (``datagen`` its arguments), both looked up by name. The datagen's draws
    (stratified depths, pose shifts) come from a generator seeded with 0,
    the datagen's own default: one case a cell, the same in every run.
    (Drawn from the run's seed, the LCA cell's depths moved the carve and
    with it the step at which compaction engages, 0 or 2,700: the seed
    changed the work.) The jobs' seeds drive the training: its weights and
    the batches it draws."""
    from nerf_for_angiography_tpu_torch import data
    from nerf_for_angiography_tpu_torch.data import datasets

    vol = dict(config["volume"])
    make_volume = getattr(data, vol.pop("make"))
    make_datagen = getattr(datasets, config["datagen_make"])
    volume = make_volume(**vol)
    dcfg = make_datagen(**datagen)
    gen = torch.Generator(device=device).manual_seed(0)
    ds = data.generate_dataset(volume, dcfg, generator=gen, device=device)
    return ds.rays, float(dcfg.src_pt[2])


def run_window(job, seconds: float, watch, sync, round_len: int = 1) -> tuple[list, float]:
    """Jobs ``job(j)`` back to back from the window's open, each under the
    context ``watch(j)``. Closes at the end of the first round of
    ``round_len`` jobs that ends at or after ``seconds``. Returns (the jobs'
    results, the window's seconds)."""
    results = []
    t_open = time.perf_counter()
    while True:
        with watch(len(results)):
            results.append(job(len(results)))
        sync()
        if len(results) % round_len == 0 and time.perf_counter() - t_open >= seconds:
            return results, time.perf_counter() - t_open


def heldout_psnr(torch, tm, state, cfg, near: float, far: float, test) -> float:
    """The held-out PSNR of a job's final state: the port's held-out render
    (its eval step, the dense lattice), the error taken here in float64
    against the dataset's held-out pixels: -10 log10(MSE)."""
    step = tm.make_eval_step(state.model, dataclasses.replace(cfg, compact_samples=0), near, far)
    _, pixels = step(state, test)
    mse = float(((pixels.double() - test.pixel_values.double()) ** 2).mean())
    return -10.0 * math.log10(mse) if mse > 0 else math.inf


def jax_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & JAX_NAMES)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: str = ROOT,
             bench: str = HERE, device: str = "cuda",
             look_for_chip: bool = True) -> dict | None:
    """One run of a cell; the result's dict, or None when it may print none.
    ``device`` and ``look_for_chip`` are for the CPU tests."""
    spec = load_cell(workload, root, bench)
    import torch

    stages = {"torch imported": process_age()}

    chips = int(spec["cell"]["chips"])
    if look_for_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"portbench: {workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return None
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import TrainConfig, graph, loop

    # the step module (the package re-exports the loop's ``train`` under its name)
    tm = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")

    from . import check, steps_profile
    from .reference import steps as reference

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    train, datagen, n_iters = settings(spec["config"], spec["traffic"], seed)
    stages["port imported"] = process_age()
    rays, src_z = make_dataset(torch, spec["config"], datagen, dev)
    sync()
    stages["dataset"] = process_age()

    seeds = job_seeds(spec["traffic"], seed)

    def job(j: int, iters: int = n_iters):
        cfg = TrainConfig(**{**train, "seed": seeds[j % len(seeds)], "n_iters": iters})
        with contextlib.redirect_stdout(sys.stderr):
            return loop.train(cfg, rays, src_z, log_dir=None, device=dev)

    job(0, int(spec["traffic"]["warmup_iters"]))
    sync()
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = stages["warm-up job"] = process_age()
    print("set-up (s since the process started): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()), file=sys.stderr)
    taps = []

    def watch(j: int):
        taps.append(check.StepTap(graph.TrainChunk))
        return taps[-1]

    results, window_s = run_window(job, seconds, watch, sync, len(seeds))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    cfg = TrainConfig(**{**train, "n_iters": n_iters})
    batch = cfg.sample_size ** 2
    near, far = src_z - cfg.outside, src_z + cfg.outside
    n_views = int(rays.image_ids.max()) + 1
    rpv = rays.num_rays // n_views
    test = tm.make_test_view(rays, n_views - 1, rpv)
    ctx = dict(
        setup_s=setup_s, window_s=window_s, batch=batch, depth_samples=cfg.depth_samples_per_ray,
        hybrid_split=cfg.hybrid_split, mlp=(3, cfg.num_hidden_units, cfg.num_layers),
        encoding=dict(name=cfg.pos_enc, bands=0 if cfg.pos_enc == "none" else cfg.pos_enc_basis),
        jobs=[dict(timing=r.timing, iters_run=r.iters_run,
                   heldout_psnr_db=heldout_psnr(torch, tm, r.state, cfg, near, far, test))
              for r in results],
        profile=None,
    )
    last = results[-1]
    breakdown = None
    if trace and cuda:
        tr = tm.drop_test_view(rays, n_views - 1, rpv)
        tr = tr._replace(sampling_table=build_sampling_table(tr.weights))
        ctx["profile"] = steps_profile.profile_steps(
            torch, tm, last.state, tr, cfg, near, far,
            steps_profile.busiest_tuning(last.timing, batch))
        breakdown = {"device_ops": ctx["profile"]["device_ops"],
                     "idle_gaps": ctx["profile"]["idle_gaps"]}
    metrics = read_metrics(spec["per_layer"] if trace else spec["end_to_end"], ctx, bench)
    failed = sum(not math.isfinite(j["heldout_psnr_db"]) for j in ctx["jobs"])
    del results, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    inputs = {k: getattr(rays, k) for k in ("origins", "directions", "pixel_values", "weights",
                                            "image_ids")}
    ref_spec = check.reference_spec(train, src_z)
    numbers = check.worst([
        check.compare(tap.obs, reference.follow(ref_spec, inputs, seeds[j % len(seeds)],
                                                check.N_STEPS))
        for j, tap in enumerate(taps)])
    ok, table = check.judge(numbers, check.load_limits(workload, bench))
    found = jax_modules()
    if found:
        print(f"portbench: the process holds {found} after the window", file=sys.stderr)
        return None
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": chips if cuda else 0, "memory_peak_bytes": int(peak),
    }
    if ctx["profile"] is not None:
        device_info["busy_s"] = ctx["profile"]["busy_s"]
        device_info["window_s"] = ctx["profile"]["window_s"]
    result = {"correct": bool(ok and failed == 0), "attempted": len(ctx["jobs"]),
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else None,
                            "limit": v["limit"]} for k, v in table.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_cache_dirs()
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    if result is None:
        return 2
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']}"
        print(f"check {name}: {c['value']} ({limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
