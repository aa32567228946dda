#!/usr/bin/env python3
"""Drive the PyTorch port (``nerf_for_angiography_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # the checks below
    python3 chip_smoke.py --determinism      # also: run-to-run reproducibility
    python3 chip_smoke.py --protocol 20000   # also: one 20k-step shipped run

Phases:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. every kernel library built from ``csrc/`` (one nvcc per source, all
     started together), and the fused-MLP kernels held against their plain
     PyTorch versions on the card at the dense path's shapes and timed
     (CUDA events);
  3. dense training: 60 dense-lattice steps at full width (4x128 CPPN, 75^2
     rays x 300 samples, two 128^3 grids, carve_init) on the vessel
     phantom, the launch counters read around the run, then 16 more steps
     timed and traced with ``torch.profiler`` (device time by kernel, the
     device's busy share);
  4. compacted training at the shipped ``TrainConfig()`` defaults (600
     steps: dense until the chooser engages, then the compacted stepper the
     chooser and the pressure tuner pick), and 300 steps with
     ``march_mode='hybrid'``, each with its launch counters read around it:
     the first-k kernel must have launched once per step in modes that call
     it (twice in the two-bucket modes); then the first-k kernel held
     bit-for-bit against its plain version on masks of the trained grid at
     the training path's shapes, the fused-MLP kernels re-timed at the
     compacted point count, and 16 compacted steps profiled (no host wait
     for the device inside a step);
  5. one JSON line with the kernel table, the card's name/power line, and the
     final ``{"ok": true, ...}`` line.

Any failed check exits non-zero before the final line. Without CUDA, or
without the package beside this file, it exits non-zero and prints no
result. Details also go to ``smoke_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import argparse
import dataclasses
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor rate and
# HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FWD_SHAPES = (1_687_500, 2_097_152, 524_288, 3_000_000)  # train, grid warmup, grid slab, eval
TRAIN_P = 1_687_500  # 5625 rays x 300 samples
FWD_MAX_ABS, FWD_MEDIAN_ABS, GRAD_NORM_MAX = 2e-2, 1e-3, 3e-2
DX_BAD_SHARE = 1e-5  # at most ~17 of 1,687,500 points
# a relu pre-activation this close to 0 can change sign between two f32 sum
# orders once an upstream activation rounds to a neighbouring bf16 value
RELU_TIE = 1e-3
# the shapes the compacted training path gives the first-k kernel: the
# lattice (5,625 rays x 300 samples) at k 96 / 192, a single-bucket hybrid
# window (224, k 128), and the two buckets of the shipped split 0.75 (4,218
# rays at w_lo 48 with k_lo 56 > w_lo; 1,407 rays at w_cap 160)
FK_SHAPES = ((5625, 300, 96), (5625, 300, 192), (5625, 224, 128), (4218, 48, 56),
             (1407, 160, 96))
SRC_Z = 1500.0  # the phantom's source distance (bench.py's datagen)
COMPACT_ITERS, HYBRID_ITERS = 600, 300
DEVICE = "cuda"
HERE = os.path.dirname(os.path.abspath(__file__))


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def time_ms(torch, fn, reps: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event timings of fn() after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def mlp_flops(p: int, f: int, nh: int) -> tuple[float, float]:
    """(forward, backward) FLOP of the 3 -> F -> nh x (F -> F) -> 1 MLP over
    p points; backward = recompute + dW + dx/dh products."""
    fwd = 2.0 * p * (3 * f + nh * f * f + f)
    dw = 2.0 * p * (3 * f + nh * f * f + f)
    dh = 2.0 * p * (nh * f * f + 3 * f)
    return fwd, fwd + dw + dh


def min_abs_preact(torch, packed, x):
    """Per point, the smallest |pre-activation| over every relu of the plain
    forward (same cast points as the kernels)."""
    h = x.to(torch.bfloat16).float()
    weights = [packed.w_in[:, :3]] + list(packed.w_hid)
    dist = torch.full((x.shape[0],), float("inf"), device=x.device)
    for w, b in zip(weights, packed.bias):
        z = h @ w.float().T + b
        dist = torch.minimum(dist, z.abs().amin(dim=1))
        h = torch.relu(z).to(torch.bfloat16).float()
    return dist


def ptxas_summary(log: str, width: int) -> str:
    """Registers of each kernel at this width (and of the width-free ones),
    and any kernel that spills, from nvcc's -Xptxas -v report."""
    if not log:
        return "(built earlier in this process)"
    regs, spills, cur = {}, [], None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            mangled = ln.split("'")[1]
            short = re.search(
                r"(fwd_kernel|bwd_chain_kernel|wgrad_kernel|reduce_partials|first_k_kernel)", mangled)
            width_arg = re.search(r"ILi(\d+)E", mangled)
            cur = (short.group(1) if short else mangled) + (
                f"<{width_arg.group(1)}>" if width_arg else "")
        elif cur and "Used" in ln and "registers" in ln:
            regs[cur] = ln.split("Used")[1].split("registers")[0].strip()
        elif cur and "bytes spill stores" in ln:
            if int(ln.split("bytes spill stores")[0].split(",")[-1]) > 0:
                spills.append(cur)
    keep = [f"{k} {v} registers" for k, v in regs.items() if f"<{width}>" in k or "<" not in k]
    return "; ".join(keep) + f"; spills: {', '.join(spills) or 'none'}"


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")




def build_kernels(fm, fk) -> None:
    """Build every kernel library at once: one nvcc per source, started
    together (each library builds under its own lock)."""
    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        futs = [(mod, ex.submit(timed, mod._load_lib)) for mod in (fm, fk)]
        secs = [(mod, f.result()) for mod, f in futs]
    print(f"kernel builds {time.perf_counter() - t0:.1f} s in parallel ("
          + ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]} {s:.1f} s" for mod, s in secs) + ")")
    print("nvcc ptxas fused_mlp:", ptxas_summary(fm.build_log, 128))
    print("nvcc ptxas first_k:", ptxas_summary(fk.build_log, 0))


def check_fwd(torch, fm, packed, p: int, gen, pbytes: int, label: str) -> dict:
    """The forward kernel against its plain version at P = p, timed."""
    f, nh = packed.width, packed.n_hidden
    dev = torch.device(DEVICE)
    x = (torch.rand((p, 3), generator=gen) * 2.0 - 1.0).to(dev)
    got = fm.fused_mlp_fwd_cuda(packed, x)
    want = fm.fused_mlp_fwd_reference(packed, x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, med_err = float(err.max()), float(err.median())
    ok = bool(torch.isfinite(got).all()) and max_err <= FWD_MAX_ABS and med_err <= FWD_MEDIAN_ABS
    k_ms = time_ms(torch, lambda: fm.fused_mlp_fwd_cuda(packed, x))
    p_ms = time_ms(torch, lambda: fm.fused_mlp_fwd_reference(packed, x), reps=5, warmup=1)
    b_ms, b_by = bound_ms(mlp_flops(p, f, nh)[0], p * 3 * 4 + p * 4 + pbytes)
    print(
        f"fused_mlp_fwd P={p} ({label}): max_abs_err {max_err:.3e} (limit {FWD_MAX_ABS}) "
        f"median_abs_err {med_err:.3e} (limit {FWD_MEDIAN_ABS}) kernel_ms {k_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by}) plain_ms {p_ms:.4f} library_ms null "
        "(no single PyTorch call computes the MLP chain)"
    )
    check(ok, f"fused_mlp_fwd disagrees with its plain version at P={p}")
    return dict(P=p, label=label, max_abs_err=max_err, median_abs_err=med_err, ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def check_bwd(torch, fm, packed, p: int, gen, pbytes: int, label: str) -> dict:
    """The backward kernel against its plain version at P = p (parameter
    grads normalised, dx per point except relu ties), bit-determinism, and
    its time."""
    f, nh = packed.width, packed.n_hidden
    dev = torch.device(DEVICE)
    x = (torch.rand((p, 3), generator=gen) * 2.0 - 1.0).to(dev)
    g = (torch.randn((p,), generator=gen) / p).to(dev)
    grads_k, dx_k = fm.fused_mlp_bwd_cuda(packed, x, g)
    grads_p, dx_p = fm.fused_mlp_bwd_reference(packed, x, g)
    grads_k2, dx_k2 = fm.fused_mlp_bwd_cuda(packed, x, g)
    torch.cuda.synchronize()
    flat_k = [t for pair in grads_k for t in pair] + [dx_k]
    flat_p = [t for pair in grads_p for t in pair] + [dx_p]
    flat_k2 = [t for pair in grads_k2 for t in pair] + [dx_k2]
    norm_errs, abs_errs = [], []
    for a, b in zip(flat_k, flat_p):
        d = float((a - b.reshape(a.shape)).abs().max())
        abs_errs.append(d)
        norm_errs.append(d / max(float(b.abs().max()), 1e-30))
    # dx is per point: a relu mask that flips between the two versions (an
    # f32 sum taken in another order rounds to another bf16 activation)
    # moves that one point's dx. dx is held to the limit at every point
    # except such relu ties: a point beyond it must have a pre-activation
    # within RELU_TIE of 0 in the plain forward, and such points must stay
    # below DX_BAD_SHARE of all
    ddx = (dx_k - dx_p).abs()
    dx_rel_l2 = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    bad = (ddx > GRAD_NORM_MAX * dx_p.abs().max()).any(dim=1)
    dx_bad_share = float(bad.float().mean())
    tie_dist = min_abs_preact(torch, packed, x[bad])
    dx_bad_are_ties = bool((tie_dist < RELU_TIE).all())
    deterministic = all(torch.equal(a, b) for a, b in zip(flat_k, flat_k2))
    finite = all(bool(torch.isfinite(t).all()) for t in flat_k)
    k_ms = time_ms(torch, lambda: fm.fused_mlp_bwd_cuda(packed, x, g))
    p_ms = time_ms(torch, lambda: fm.fused_mlp_bwd_reference(packed, x, g), reps=5, warmup=1)
    grad_bytes = sum(t.numel() * 4 for t in flat_k[:-1])
    b_ms, b_by = bound_ms(mlp_flops(p, f, nh)[1], p * 3 * 4 + p * 4 + p * 3 * 4 + pbytes + grad_bytes)
    print(
        f"fused_mlp_bwd P={p} ({label}): max normalised grad err {max(norm_errs[:-1]):.3e} "
        f"(limit {GRAD_NORM_MAX}); dx max normalised {norm_errs[-1]:.3e} (limit "
        f"{GRAD_NORM_MAX} except at relu ties), relative L2 {dx_rel_l2:.3e}, points beyond "
        f"the limit {int(bad.sum())} = {dx_bad_share:.2e} of all (limit {DX_BAD_SHARE:.0e}), "
        f"each with a |pre-activation| <= {float(tie_dist.max()) if len(tie_dist) else 0.0:.3e} "
        f"(a relu tie if < {RELU_TIE}); max_abs_err {max(abs_errs):.3e} "
        f"bit-deterministic {deterministic} kernel_ms {k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
        f"plain_ms {p_ms:.4f} library_ms null (no single PyTorch call computes the MLP chain)"
    )
    check(finite and max(norm_errs[:-1]) <= GRAD_NORM_MAX and dx_bad_are_ties
          and dx_bad_share <= DX_BAD_SHARE,
          f"fused_mlp_bwd disagrees with its plain version at P={p}")
    check(deterministic, "fused_mlp_bwd is not bit-deterministic across two runs")
    return dict(P=p, label=label, max_abs_err=max(abs_errs), norm_errs=norm_errs,
                dx_rel_l2=dx_rel_l2, dx_bad_share=dx_bad_share, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by)


def packed_of(torch, fm, model):
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    return packed, sum(t.numel() * t.element_size() for t in packed)


def random_mlp(torch, fm):
    """The MLP the kernel checks use: random 4x128 weights with non-zero
    biases (so the bias path is exercised), the limits above are set for it."""
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig

    gen = torch.Generator().manual_seed(0)
    model = CPPN(CPPNConfig(num_early_layers=4, num_filters=128), generator=gen)
    with torch.no_grad():
        for lin in model.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    return (*packed_of(torch, fm, model.to(DEVICE)), gen)


def kernel_phase(torch, fm, report: dict) -> list[dict]:
    """The fused-MLP kernels against their plain versions at the dense
    path's shapes."""
    packed, pbytes, gen = random_mlp(torch, fm)
    labels = dict(zip(FWD_SHAPES, ("train", "grid warmup", "grid slab", "eval")))
    fwd = [check_fwd(torch, fm, packed, p, gen, pbytes, labels[p]) for p in FWD_SHAPES]
    bwd = check_bwd(torch, fm, packed, TRAIN_P, gen, pbytes, "train")
    report["fwd"], report["bwd"] = fwd, bwd
    src = "nerf_for_angiography_tpu_torch/csrc/fused_mlp.cu"
    rows = []
    for name, r, line in (("fused_mlp_fwd", fwd[0], 142), ("fused_mlp_bwd", bwd, 160)):
        rows.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"nerf_for_angiography_tpu/ops/pallas/fused_mlp.py:{line}",
            launches=0, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        ))
    return rows


def make_dataset(torch):
    """The vessel phantom as bench.py:173-182 makes it: 26 views of 100x100."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )

    t0 = time.perf_counter()
    ds = generate_dataset(
        make_vessel_volume(res=96),
        DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=100, img_height=100,
                      sample_outside=100.0, stratified_depths=False),
        device=DEVICE,
    )
    torch.cuda.synchronize()
    print(f"datagen: {ds.rays.num_rays} rays, {ds.images.shape[0]} views, "
          f"{time.perf_counter() - t0:.2f} s")
    return ds


def train_loss(torch, state, rays, cfg) -> tuple[float, list]:
    """Loss of the trained model on one training batch (not part of the
    run), and the rendered pixels' shape."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import render_rays

    dense = dataclasses.replace(cfg, compact_samples=0)
    with torch.no_grad():
        batch = sample_pixel_rays(state.generator, rays, cfg.img_sample_size, impl="gumbel")
        near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
        pix, _, _ = render_rays(state.model, state.grid, batch.origins, batch.directions,
                                dense, near, far)
        loss = float(torch.mean((pix - batch.pixel_values) ** 2))
    check(tuple(pix.shape) == (cfg.img_sample_size,) and bool(torch.isfinite(pix).all()),
          "rendered pixels have the wrong shape or are not finite")
    return loss, list(pix.shape)


def training_phase(torch, fm, ds, report: dict) -> dict:
    """60 dense-lattice steps (compact_samples=0), launch counts read around
    the run, then the dense step profile."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    cfg = TrainConfig(compact_samples=0, n_iters=60, display_every=30)
    steps = cfg.n_iters + 1  # the loop steps iterations 0..n_iters
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)

    fm.reset_counts()
    res = train(cfg, ds.rays, src_pt_z=SRC_Z, verbose=True, device=DEVICE)
    torch.cuda.synchronize()
    fwd_n, bwd_n = fm.fwd_launches, fm.bwd_launches

    loss, pix_shape = train_loss(torch, res.state, ds.rays, cfg)
    t = res.timing
    steady_steps = cfg.n_iters  # the first step is charged to "compile"
    ms_step = 1e3 * t["step_dense"] / steady_steps
    rays_s = steady_steps * cfg.img_sample_size / t["step_dense"]
    out = dict(
        steps=steps, ms_per_step=ms_step, steady_rays_per_s=rays_s,
        rays_per_s_incl_first=res.rays_per_sec, train_loss=loss,
        heldout_psnr=res.last_psnr, best_heldout_psnr=res.best_heldout_psnr,
        fwd_launches=fwd_n, bwd_launches=bwd_n, grid_updates=grid_updates, evals=evals,
        timing={k: v for k, v in t.items() if isinstance(v, (int, float))},
        pix_shape=pix_shape,
    )
    print(
        f"training: {steps} steps, {ms_step:.3f} ms/step, {rays_s:.0f} rays/s steady, "
        f"train loss {loss:.6f}, held-out PSNR {res.last_psnr:.3f} dB "
        f"(best-checkpoint {res.best_heldout_psnr:.3f}), launches fwd {fwd_n} bwd {bwd_n} "
        f"(steps {steps}, grid updates {grid_updates}, evals {evals})"
    )
    report["training"] = out
    check(math.isfinite(loss) and math.isfinite(res.last_psnr), "training loss/PSNR not finite")
    check(bwd_n == steps, f"bwd launches {bwd_n} != steps {steps}")
    check(fwd_n >= steps + grid_updates + evals,
          f"fwd launches {fwd_n} < steps + grid updates + evals")
    out["profile"] = step_profile(torch, res.state, ds.rays, cfg)
    return out


def step_profile(torch, state, rays, cfg, n_steps: int = 16) -> dict:
    """Where a training step's time goes: ``n_steps`` more steps of the
    trained state at ``cfg`` (one grid update among them, as in the run),
    timed on the host clock without the profiler (also the time the host
    takes to issue them, up to the final synchronize), then traced with
    ``torch.profiler`` for device time by kernel, the device's busy share
    and the host's waits for the device (stream syncs, device-to-host
    copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import make_train_step

    rays = rays._replace(sampling_table=build_sampling_table(rays.weights))
    step = make_train_step(state.model, cfg, SRC_Z - cfg.outside, SRC_Z + cfg.outside)

    def run() -> float:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(state, rays)
        issued = time.perf_counter()
        torch.cuda.synchronize()
        return issued - t0

    run()  # warm
    t0 = time.perf_counter()
    issue_ms = 1e3 * run() / n_steps
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows, host_rows, host_waits = [], [], 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total > 0:
            host_rows.append((ev.self_cpu_time_total / 1e3 / n_steps, ev.count / n_steps, ev.key))
        # the host waits for the device: stream syncs, device-to-host copies
        if ev.key == "cudaStreamSynchronize" or "DtoH" in ev.key:
            host_waits += ev.count
        if ev.device_type != DeviceType.CUDA:  # kernels and copies only, not the ops above them
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n_steps, ev.count / n_steps, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    out = dict(wall_ms_per_step=wall_ms, host_issue_ms_per_step=issue_ms,
               host_waits_per_step=host_waits / n_steps,
               device_ms_per_step=device_ms, device_ops_per_step=launches,
               busy_share=device_ms / wall_ms if rows else None,
               top=[dict(ms_per_step=m, calls_per_step=c, name=k[:120]) for m, c, k in rows[:15]],
               host_top=[dict(ms_per_step=m, calls_per_step=c, name=k[:120])
                         for m, c, k in sorted(host_rows, reverse=True)[:10]])
    if not rows:
        print("step profile: the profiler saw no device time (not measured)")
        return out
    print(f"step profile ({n_steps} steps): wall {wall_ms:.3f} ms/step without the profiler "
          f"(host done issuing after {issue_ms:.3f} ms/step, {host_waits / n_steps:.2f} waits "
          f"for the device per step), device {device_ms:.3f} ms/step in {launches:.1f} "
          f"kernels and copies per step, busy share {device_ms / wall_ms:.3f}")
    for m, c, k in rows[:15]:
        print(f"  {m:9.4f} ms/step  {c:6.2f} calls/step  {k[:100]}")
    print("host time by op (profiled, self CPU time):")
    for r in out["host_top"]:
        print(f"  {r['ms_per_step']:9.4f} ms/step  {r['calls_per_step']:6.2f} calls/step  "
              f"{r['name'][:100]}")
    return out


def tuning_cfg(cfg, t: dict):
    """The step configuration of one compacted-stepper Tuning, as the loop
    builds it."""
    return dataclasses.replace(
        cfg, march_mode=t["mode"], compact_samples=t["k"], hybrid_w_cap=t["w_cap"],
        hybrid_w_lo=t["w_lo"], hybrid_k_lo=t["k_lo"],
    )


def first_k_calls_per_step(fk, cfg, t: dict, grid, batch) -> int:
    """First-k launches one step of Tuning ``t`` makes: read off one march
    of that Tuning on a training batch (outside every counted run)."""
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    fk.reset_counts()
    _march_for(tuning_cfg(cfg, t), grid, batch.origins, batch.directions,
               SRC_Z - cfg.outside, SRC_Z + cfg.outside)
    return fk.launches


def compacted_run(torch, fm, fk, ds, cfg, label: str) -> dict:
    """One train() run with the launch counters set to 0 just before it and
    read just after; the first-k launches must equal the compacted steps
    times the launches a step of their Tuning makes."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import train

    print(f"--- {label}: {cfg.n_iters + 1} steps, march_mode={cfg.march_mode}")
    fm.reset_counts()
    fk.reset_counts()
    res = train(cfg, ds.rays, src_pt_z=SRC_Z, verbose=True, device=DEVICE)
    torch.cuda.synchronize()
    fwd_n, bwd_n, fk_n, fk_shapes = fm.fwd_launches, fm.bwd_launches, fk.launches, set(fk.shapes)

    steps = res.iters_run + 1
    t = res.timing
    phases = t["steady_phases"]
    batch = sample_pixel_rays(res.state.generator, ds.rays, cfg.img_sample_size, impl="gumbel")
    per_step = [first_k_calls_per_step(fk, cfg, p, res.state.grid, batch) for p in phases]
    expected_fk = sum(n * p["steps"] for n, p in zip(per_step, phases))
    compact_steps = sum(p["steps"] for p in phases)
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)
    loss, _ = train_loss(torch, res.state, ds.rays, cfg)
    out = dict(
        label=label, steps=steps, compact_steps=compact_steps, fwd_launches=fwd_n,
        bwd_launches=bwd_n, first_k_launches=fk_n, first_k_expected=expected_fk,
        first_k_shapes=sorted(fk_shapes), tuning_final=t["tuning_final"],
        steady_rays_per_sec=t["steady_rays_per_sec"], step_compact_s=t["step_compact"],
        step_dense_s=t["step_dense"], choose_s=t["choose"], compile_s=t["compile"],
        total_s=t["total"], pressure_fired=t["pressure_fired"],
        pressure_muted=t["pressure_muted"], decay_bounces=t["decay_bounces"],
        phases=[{**p, "first_k_per_step": n} for p, n in zip(phases, per_step)],
        train_loss=loss, heldout_psnr=res.last_psnr, best_heldout_psnr=res.best_heldout_psnr,
        rays_per_s_incl_first=res.rays_per_sec,
    )
    print(f"{label}: final Tuning {t['tuning_final']}, steady_rays_per_sec "
          f"{t['steady_rays_per_sec']:.0f}, step_compact {t['step_compact']:.3f} s, "
          f"step_dense {t['step_dense']:.3f} s, choose {t['choose']:.3f} s, compile "
          f"{t['compile']:.3f} s, total {t['total']:.3f} s; pressure fired "
          f"{t['pressure_fired']} muted {t['pressure_muted']} decay bounces "
          f"{t['decay_bounces']}")
    for p, n in zip(phases, per_step):
        print(f"  phase {p['mode']} k={p['k']} w_cap={p['w_cap']} w_lo={p['w_lo']} "
              f"k_lo={p['k_lo']}: {p['steps']} steps ({p['rays']} steady rays in "
              f"{p['wall_s']:.3f} s), {n} first-k launches per step")
    print(f"{label}: launches fwd {fwd_n} bwd {bwd_n} first_k {fk_n} (expected {expected_fk} "
          f"from {compact_steps} compacted steps; shapes {sorted(fk_shapes)}); steps {steps}, "
          f"grid updates {grid_updates}, evals {evals}; train loss {loss:.6f}, held-out PSNR "
          f"{res.last_psnr:.3f} dB (best-checkpoint {res.best_heldout_psnr:.3f})")
    check(math.isfinite(loss) and math.isfinite(res.last_psnr), f"{label}: loss/PSNR not finite")
    check(bwd_n == steps, f"{label}: bwd launches {bwd_n} != steps {steps}")
    check(fwd_n >= steps + grid_updates + evals,
          f"{label}: fwd launches {fwd_n} < steps + grid updates + evals")
    check(fk_n == expected_fk, f"{label}: first_k launches {fk_n} != expected {expected_fk}")
    out["result"] = res
    return out


def fk_masks(torch, grid, cfg, batch, rows: int, w: int):
    """(rows, w) first-k input masks from the marches of the trained grid: the
    dense lattice (w = depth) or the hybrid window mask at width w of the
    whole batch, its lo bucket or its hi bucket (the span-sorted split),
    with rows that are all zero, all one and denser than any k put first."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import (
        _span_sorted, coarse_window, hybrid_window_mask, march_rays, safe_occ_stride,
    )

    n, near, far = cfg.depth_samples_per_ray, SRC_Z - cfg.outside, SRC_Z + cfg.outside
    stride = safe_occ_stride(cfg.occ_stride, n, near, far, 2 * cfg.outside, cfg.grid_resolution)
    o, d = batch.origins, batch.directions
    if w == n:
        mask = march_rays(grid, o, d, n, near, far, occ_stride=stride).mask[:rows]
    else:
        r_all = o.shape[0]
        if rows == r_all:
            start, _, hit = coarse_window(grid, o, d, n, near, far, aabb_extent=2 * cfg.outside)
        else:
            _, st_s, ah_s, o_s, d_s = _span_sorted(grid, o, d, n, near, far, None,
                                                   2 * cfg.outside)
            sl = slice(0, rows) if rows == int(r_all * cfg.hybrid_split) else slice(r_all - rows,
                                                                                     r_all)
            start, hit, o, d = st_s[sl], ah_s[sl], o_s[sl], d_s[sl]
        _, mask = hybrid_window_mask(grid, o, d, start, hit, n, near, far, w, stride)
    mask = mask.clone()
    e = min(8, rows // 3)
    gen = torch.Generator(device=mask.device).manual_seed(rows + w)
    mask[:e] = 0.0
    mask[e:2 * e] = 1.0
    mask[2 * e:3 * e] = (torch.rand((e, w), generator=gen, device=mask.device) < 0.9).float()
    return mask


def fk_bytes(torch, mask, k: int) -> tuple[int, int]:
    """(bytes this data needs, bytes of the interface): the row read up to
    its k-th active sample (all of it when it has fewer) plus sel and
    mask_k written; the interface count reads every row in full."""
    rows, w = mask.shape
    rank = torch.cumsum(mask, dim=-1)
    full = rank[:, -1] >= k
    kth = torch.argmax((rank >= k).to(torch.uint8), dim=-1)
    read = torch.where(full, kth + 1, torch.full_like(kth, w))
    out = rows * k * 8
    return int(read.sum()) * 4 + out, rows * w * 4 + out


def fk_kernel_ms(torch, fk, mask, k: int, n: int = 50) -> float:
    """The kernel alone: CUDA events around ``n`` back-to-back launches
    through the C interface into preallocated outputs, per launch (one
    wrapper call costs more host time than the kernel takes on the card)."""
    rows, w = mask.shape
    sel = torch.empty((rows, k), dtype=torch.int32, device=mask.device)
    mk = torch.empty((rows, k), dtype=torch.float32, device=mask.device)
    lib = fk._load_lib()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    args = (mask.data_ptr(), rows, w, k, sel.data_ptr(), mk.data_ptr(), stream)

    def launches():
        for _ in range(n):
            lib.first_k_active_launch(*args)

    return time_ms(torch, launches, reps=10, warmup=2) / n


def check_first_k(torch, fk, grid, cfg, batch, shapes) -> list[dict]:
    """The kernel against its plain version, bit for bit, at each shape, with
    its time, the plain version's, a two-call composite's and the bound."""
    out = []
    for rows, w, k in shapes:
        mask = fk_masks(torch, grid, cfg, batch, rows, w)
        sel, mk = fk.first_k_active_cuda(mask, k)
        want_sel, want_mk = fk.first_k_active_reference(mask, k)
        torch.cuda.synchronize()
        equal = torch.equal(sel, want_sel) and torch.equal(mk, want_mk)
        err = max(float((sel - want_sel).abs().max()), float((mk - want_mk).abs().max()))
        call_ms = time_ms(torch, lambda: fk.first_k_active_cuda(mask, k), reps=50, warmup=5)
        k_ms = fk_kernel_ms(torch, fk, mask, k)
        p_ms = time_ms(torch, lambda: fk.first_k_active_reference(mask, k), reps=10, warmup=2)
        j = torch.arange(k, dtype=torch.float32, device=mask.device).expand(rows, k).contiguous()

        def composite():
            rank = torch.cumsum(mask, dim=-1)
            return torch.searchsorted(rank, j, right=True)

        c_ms = time_ms(torch, composite, reps=20, warmup=3)
        need, iface = fk_bytes(torch, mask, k)
        b_ms, b_by = bound_ms(0.0, need)
        i_ms, _ = bound_ms(0.0, iface)
        actives = mask.sum(dim=-1)
        print(
            f"first_k_active R={rows} w={w} k={k}: bit-identical {equal} (max_abs_err {err}) "
            f"kernel_ms {k_ms:.4f} (one wrapper call {call_ms:.4f}) "
            f"bound_ms {b_ms:.4f} ({b_by}: {need} B this data needs; "
            f"{i_ms:.4f} for the {iface} B interface) plain_ms {p_ms:.4f} library_ms null "
            f"(no single PyTorch call computes it; cumsum + searchsorted(right=True) "
            f"{c_ms:.4f} ms); actives per row mean {float(actives.mean()):.1f} max "
            f"{int(actives.max())}"
        )
        check(equal, f"first_k_active disagrees with its plain version at {(rows, w, k)}")
        out.append(dict(R=rows, w=w, k=k, max_abs_err=err, ms=k_ms, call_ms=call_ms,
                        plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by, interface_bound_ms=i_ms,
                        composite_ms=c_ms, bytes_needed=need, bytes_interface=iface))
    return out


def compact_phase(torch, fm, fk, ds, report: dict) -> dict:
    """Phase 4: compacted training at the shipped defaults and forced
    hybrid, the first-k kernel on the trained grid's masks, the fused-MLP
    kernels at the compacted point count, and the compacted step profile."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import TrainConfig
    from nerf_for_angiography_tpu_torch.training.train import _flat_positions, _march_for

    cfg = TrainConfig(n_iters=COMPACT_ITERS, display_every=100)
    main = compacted_run(torch, fm, fk, ds, cfg, "shipped defaults")
    check(main["compact_steps"] > 0, "the shipped-default run never engaged the compacted stepper")
    hcfg = TrainConfig(n_iters=HYBRID_ITERS, display_every=100, march_mode="hybrid")
    hyb = compacted_run(torch, fm, fk, ds, hcfg, "forced hybrid")
    check(hyb["first_k_launches"] > 0, "the forced-hybrid run never launched the first-k kernel")

    state = main["result"].state
    batch = sample_pixel_rays(state.generator, ds.rays, cfg.img_sample_size, impl="gumbel")
    seen = sorted(set(main["first_k_shapes"]) | set(hyb["first_k_shapes"]))
    fk_rows = check_first_k(torch, fk, state.grid, cfg, batch,
                            list(FK_SHAPES) + [s for s in seen if s not in FK_SHAPES])
    # the kernel table's row: the main path's largest shape (else the
    # forced-hybrid run's)
    path_shapes = main["first_k_shapes"] or hyb["first_k_shapes"]
    key = max(path_shapes, key=lambda s: s[0] * s[1])
    fk_row = next(r for r in fk_rows if (r["R"], r["w"], r["k"]) == key)

    # the fused-MLP kernels at the point count of the final Tuning's step
    final = main["tuning_final"] or hyb["tuning_final"]
    fcfg = tuning_cfg(cfg, final)
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    p = _flat_positions(_march_for(fcfg, state.grid, batch.origins, batch.directions,
                                   near, far)).shape[0]
    packed, pbytes, gen = random_mlp(torch, fm)
    mlp = dict(fwd=check_fwd(torch, fm, packed, p, gen, pbytes, f"compacted step {final}"),
               bwd=check_bwd(torch, fm, packed, p, gen, pbytes, f"compacted step {final}"))

    print(f"compacted step profile at the final Tuning {final}:")
    prof = step_profile(torch, state, ds.rays, fcfg)
    check(prof["host_waits_per_step"] == 0,
          f"the compacted step waits for the device {prof['host_waits_per_step']} times a step")
    two = two_bucket_steps(torch, fm, fk, state, ds.rays, cfg, batch)
    for run in (main, hyb):
        run.pop("result")
    out = dict(shipped=main, hybrid=hyb, first_k=fk_rows, first_k_row=fk_row, mlp=mlp,
               profile=prof, compact_p=p, two_bucket=two)
    report["compact"] = out
    return out


# a two-bucket (hybrid2k) Tuning at the shapes of a pruned grid: the chooser
# picks this march once the spans have shrunk, which a short run may not see
TWO_BUCKET = dict(mode="hybrid", k=96, w_cap=160, w_lo=48, k_lo=56)
TWO_BUCKET_STEPS = 50


def two_bucket_steps(torch, fm, fk, state, rays, cfg, batch) -> dict:
    """TWO_BUCKET_STEPS steps of the trained state at the fixed two-bucket
    Tuning, launch counts read around them (two first-k launches a step),
    then that step's profile."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import make_train_step
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    tcfg = tuning_cfg(cfg, TWO_BUCKET)
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    m = _march_for(tcfg, state.grid, batch.origins, batch.directions, near, far)
    check(isinstance(m, BucketedRays), f"{TWO_BUCKET} does not march two buckets")
    step = make_train_step(state.model, tcfg, near, far)
    rays = rays._replace(sampling_table=build_sampling_table(rays.weights))
    fm.reset_counts()
    fk.reset_counts()
    for _ in range(TWO_BUCKET_STEPS):
        _, metrics, _, _ = step(state, rays)
    torch.cuda.synchronize()
    out = dict(tuning=TWO_BUCKET, steps=TWO_BUCKET_STEPS, fwd_launches=fm.fwd_launches,
               bwd_launches=fm.bwd_launches, first_k_launches=fk.launches,
               first_k_shapes=sorted(fk.shapes),
               pressure={k: int(v) for k, v in metrics.items() if k.startswith("march/")})
    print(f"two-bucket steps {TWO_BUCKET}: {TWO_BUCKET_STEPS} steps, launches fwd "
          f"{fm.fwd_launches} bwd {fm.bwd_launches} first_k {fk.launches} (shapes "
          f"{sorted(fk.shapes)}), last step's pressure {out['pressure']}")
    check(fm.bwd_launches == TWO_BUCKET_STEPS and fk.launches == 2 * TWO_BUCKET_STEPS,
          "the two-bucket steps did not launch one backward and two first-k kernels a step")
    print(f"two-bucket step profile at {TWO_BUCKET}:")
    out["profile"] = step_profile(torch, state, rays, tcfg)
    check(out["profile"]["host_waits_per_step"] == 0,
          "the two-bucket step waits for the device inside a step")
    return out


def determinism_phase(torch, fm, ds, report: dict) -> None:
    """The 60-step dense run twice with the default algorithms and twice
    under torch.use_deterministic_algorithms(True, warn_only=True): the ops
    that warn, and whether the two runs of each end bit-identical."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    cfg = TrainConfig(compact_samples=0, n_iters=60, display_every=30)
    out = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        runs, caught = [], []
        for _ in range(2):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                res = train(cfg, ds.rays, src_pt_z=SRC_Z, verbose=False, device=DEVICE)
                torch.cuda.synchronize()
            caught += [str(w.message).splitlines()[0] for w in rec]
            sd = {k: v.detach().clone() for k, v in res.state.model.state_dict().items()}
            runs.append((sd, res.state.grid.binary.clone(), res.last_psnr))
        same_params = all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
        same_grid = torch.equal(runs[0][1], runs[1][1])
        warned = sorted(set(m for m in caught if "deterministic" in m.lower()))
        print(f"determinism ({'deterministic algorithms, warn_only' if det else 'default'}): "
              f"parameters bit-identical across two runs {same_params}, grid {same_grid}, "
              f"held-out PSNR {runs[0][2]:.6f} / {runs[1][2]:.6f}")
        for m in warned:
            print(f"  warned: {m[:300]}")
        out["deterministic" if det else "default"] = dict(
            same_params=same_params, same_grid=same_grid, warned=warned,
            psnr=[runs[0][2], runs[1][2]])
    torch.use_deterministic_algorithms(False)
    out["ops"] = nondeterministic_ops(torch, ds)
    report["determinism"] = out


def nondeterministic_ops(torch, ds, n: int = 20) -> dict:
    """Each candidate op of the dense step that could differ run to run,
    repeated ``n`` times on the same inputs with the default algorithms and
    with the deterministic ones: is every repeat bit-identical to the
    first?"""
    from nerf_for_angiography_tpu_torch.ops.occupancy import carve_feasible, prune_mask
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table, overdraw_select

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    sigma = torch.rand((5625, 300), generator=gen, device=DEVICE)
    mask = (torch.rand((5625, 300), generator=gen, device=DEVICE) < 0.3).float()
    dists = torch.full_like(sigma, 200.0 / 300)
    table = build_sampling_table(ds.rays.weights)
    draws = torch.randint(0, table.shape[0], (6329,), generator=gen, device=DEVICE)
    r = ds.rays
    cands = {}
    if DEVICE == "cuda":
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm

        packed, _, _ = random_mlp(torch, fm)
        x = torch.rand((200_000, 3), generator=gen, device=DEVICE) * 2 - 1
        g = torch.randn((200_000,), generator=gen, device=DEVICE)

        def dirty():
            # fill freed blocks with fresh random values: the next
            # torch.empty may hand them out, and a kernel that read scratch
            # before writing it would then differ between repeats
            junk = [torch.randn(1 << e, generator=gen, device=DEVICE) for e in (20, 23, 26, 28)]
            del junk

        def bwd():
            dirty()
            grads, dx = fm.fused_mlp_bwd_cuda(packed, x, g)
            return torch.cat([t.reshape(-1) for pair in grads for t in pair] + [dx.reshape(-1)])

        def fwd():
            dirty()
            return fm.fused_mlp_fwd_cuda(packed, x)

        cands["fused_mlp backward on dirty scratch"] = bwd
        cands["fused_mlp forward on dirty scratch"] = fwd
    cands.update({
        "build_sampling_table (cumsum of 260,000 ray weights)":
            lambda: build_sampling_table(r.weights),
        "prune_mask (cumsum along each of 5,625 rays)":
            lambda: prune_mask(sigma, dists, mask, 0.0, 1e-2),
        "overdraw_select (scatter_reduce amin, index_put)":
            lambda: overdraw_select(table, draws, 5625, r.num_rays),
        "carve_feasible (index_put of True)":
            lambda: carve_feasible(r.origins, r.directions, r.pixel_values,
                                   [-100.0] * 3 + [100.0] * 3, 128, 1400.0, 1600.0),
    })
    out = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for name, fn in cands.items():
            first = fn()
            same = all(torch.equal(first, fn()) for _ in range(n - 1))
            out.setdefault(name, {})["deterministic" if det else "default"] = same
    torch.use_deterministic_algorithms(False)
    for name, v in out.items():
        print(f"  {name}: bit-identical over {n} repeats: default algorithms {v['default']}, "
              f"deterministic algorithms {v['deterministic']}")
    return out


def protocol_phase(torch, ds, iters: int, report: dict) -> None:
    """One shipped-default run of ``iters`` steps, as bench.py runs the
    protocol: the best-checkpoint held-out PSNR and the steady rate."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    res = train(TrainConfig(n_iters=iters), ds.rays, src_pt_z=SRC_Z, verbose=True,
                device=DEVICE)
    t = res.timing
    out = dict(iters=iters, best_heldout_psnr=res.best_heldout_psnr, last_psnr=res.last_psnr,
               best_vessel_psnr=res.best_psnr, best_iter=res.best_iter,
               steady_rays_per_sec=t["steady_rays_per_sec"], rays_per_sec=res.rays_per_sec,
               total_s=t["total"], tuning_final=t["tuning_final"],
               steady_phases=t["steady_phases"])
    print(f"protocol {iters} steps: best-checkpoint held-out PSNR {res.best_heldout_psnr:.3f} dB "
          f"(iter {res.best_iter}), last {res.last_psnr:.3f} dB, steady "
          f"{t['steady_rays_per_sec']:.0f} rays/s, end to end {res.rays_per_sec:.0f} rays/s, "
          f"{t['total']:.1f} s")
    check(math.isfinite(res.best_heldout_psnr), "protocol run: held-out PSNR not finite")
    report["protocol"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--determinism", action="store_true",
                    help="also run the dense phase twice with and without deterministic "
                         "algorithms and report the ops that warn")
    ap.add_argument("--protocol", type=int, default=0,
                    help="also run one shipped-default training of this many steps")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run f32 products
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {kind} count {torch.cuda.device_count()}")
    print(smi)
    report: dict = {"device": kind, "nvidia_smi": smi}
    t_all = time.perf_counter()
    try:
        build_kernels(fm, fk)
        rows = kernel_phase(torch, fm, report)
        ds = make_dataset(torch)
        tr = training_phase(torch, fm, ds, report)
        cp = compact_phase(torch, fm, fk, ds, report)
        if args.determinism:
            determinism_phase(torch, fm, ds, report)
        if args.protocol:
            protocol_phase(torch, ds, args.protocol, report)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        os.makedirs(os.path.join(HERE, "smoke_out"), exist_ok=True)
        with open(os.path.join(HERE, "smoke_out", "chip_smoke.json"), "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    runs = {"dense": {**tr, "first_k_launches": 0}, "shipped_defaults": cp["shipped"],
            "forced_hybrid": cp["hybrid"], "two_bucket_steps": cp["two_bucket"]}
    by_path = {
        name: {k: r[key] for k, r in runs.items()}
        for name, key in (("fused_mlp_fwd", "fwd_launches"), ("fused_mlp_bwd", "bwd_launches"),
                          ("first_k_active", "first_k_launches"))
    }
    fk_row = cp["first_k_row"]
    rows.append(dict(
        name="first_k_active", route="cuda", source="nerf_for_angiography_tpu_torch/csrc/first_k.cu",
        replaces="nerf_for_angiography_tpu/ops/pallas/first_k.py:50", launches=0,
        max_abs_err=fk_row["max_abs_err"], ms=fk_row["ms"], plain_ms=fk_row["plain_ms"],
        bound_ms=fk_row["bound_ms"], bound_by=fk_row["bound_by"], library_ms=None,
        shape=[fk_row["R"], fk_row["w"], fk_row["k"]],
    ))
    for row in rows:
        row["launches"] = sum(by_path[row["name"]].values())
        row["launches_by_path"] = by_path[row["name"]]
        if row["launches"] == 0:
            print(f"chip_smoke: FAILED: {row['name']} never launched on the training paths",
                  file=sys.stderr)
            return 1
    for row, key in ((rows[0], "fwd"), (rows[1], "bwd")):
        r = cp["mlp"][key]
        row["compact_path"] = dict(P=r["P"], ms=r["ms"], plain_ms=r["plain_ms"],
                                   bound_ms=r["bound_ms"], bound_by=r["bound_by"])
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
