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
     (CUDA events); the feature-major (3, P) launch held equal to the
     point-major one; the sampling table built 20 times, bit-identical;
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
  5. the whole-step kernel (fused_train_step): held against its plain
     version at the dense, lattice and two bucket shapes on the trained
     grid's marches with random and trained weights, two launches
     bit-identical, timed beside its bound and the split pair (MLP forward,
     PyTorch composite, MLP backward) for the same function; the fused step
     against the split step at one trained state; 60 dense and 600
     shipped-default steps with ``fused_train_step='on'`` (one launch per
     rectangular march, no split backward); the fused step profiled at the
     lattice and two-bucket Tunings; 60 dense steps with
     ``feature_major_mlp``;
  6. one JSON line with the kernel table, the card's name/power line, and the
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
# fused-MLP forward limits relative to the output scale max(1, max |raw|):
# larger raw outputs (trained weights) scale the bf16 tie flips with them
FWD_MAX_REL, FWD_MEDIAN_REL, GRAD_NORM_MAX = 2e-2, 1e-3, 3e-2
# whole-step kernel against its plain version, which shares its cast points:
# pixels (in [0, 1]) max abs and median abs, every gradient normalised by the
# plain version's max; about 10x the largest reading on the card. A ray beyond
# FS_PIX_MAX must be an early-stop tie: the plain forward's exclusive
# transmittance within FS_EPS_TIE of eps (relative) at one of its active
# samples, where the keep can flip between two sigma roundings; at most
# max(1, FS_TIE_SHARE x R) such rays
FS_PIX_MAX, FS_PIX_MEDIAN, FS_GRAD_NORM = 5e-4, 1e-5, 1e-3
FS_EPS_TIE, FS_TIE_SHARE = 1e-3, 1e-3
# the fused step against the split step, which forms x and the composite at
# other cast points (x rounded after scaling, dists = t_ends - t_starts): loss
# relative, pixels max abs and median abs, gradients normalised
WIRE_LOSS_REL, WIRE_PIX_MAX, WIRE_PIX_MEDIAN, WIRE_GRAD_NORM = 1e-2, 2e-2, 1e-3, 3e-2
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
COMPACT_ITERS, HYBRID_ITERS, DENSE_ITERS = 600, 300, 60
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
    and any kernel that spills with its spill-store bytes, from nvcc's
    -Xptxas -v report."""
    if not log:
        return "(built earlier in this process)"
    regs, spills, cur = {}, [], None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            mangled = ln.split("'")[1]
            short = re.search(
                r"(fwd_kernel|bwd_chain_kernel|wgrad_kernel|reduce_partials|first_k_kernel"
                r"|scan_kernel)", mangled)
            width_arg = re.search(r"ILi(\d+)E", mangled)
            cur = (short.group(1) if short else mangled) + (
                f"<{width_arg.group(1)}>" if width_arg else "")
        elif cur and "Used" in ln and "registers" in ln:
            regs[cur] = ln.split("Used")[1].split("registers")[0].strip()
        elif cur and "bytes spill stores" in ln:
            n = int(ln.split("bytes spill stores")[0].split(",")[-1])
            if n > 0:
                spills.append(f"{cur} ({n} B of spill stores)")
    keep = [f"{k} {v} registers" for k, v in regs.items() if f"<{width}>" in k or "<" not in k]
    return "; ".join(keep) + f"; spills: {', '.join(spills) or 'none'}"


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")




def build_kernels(fm, fk, fs) -> None:
    """Build every kernel library at once: one nvcc per source, started
    together (each library builds under its own lock)."""
    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    mods = (fm, fk, fs)
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = [(mod, ex.submit(timed, mod._load_lib)) for mod in mods]
        secs = [(mod, f.result()) for mod, f in futs]
    print(f"kernel builds {time.perf_counter() - t0:.1f} s in parallel ("
          + ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]} {s:.1f} s" for mod, s in secs) + ")")
    print("nvcc ptxas fused_mlp:", ptxas_summary(fm.build_log, 128))
    print("nvcc ptxas first_k:", ptxas_summary(fk.build_log, 0))
    print("nvcc ptxas fused_step:", ptxas_summary(fs.build_log, 128))


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
    scale = max(1.0, float(want.abs().max()))
    lim_max, lim_med = FWD_MAX_REL * scale, FWD_MEDIAN_REL * scale
    ok = bool(torch.isfinite(got).all()) and max_err <= lim_max and med_err <= lim_med
    k_ms = time_ms(torch, lambda: fm.fused_mlp_fwd_cuda(packed, x))
    p_ms = time_ms(torch, lambda: fm.fused_mlp_fwd_reference(packed, x), reps=5, warmup=1)
    b_ms, b_by = bound_ms(mlp_flops(p, f, nh)[0], p * 3 * 4 + p * 4 + pbytes)
    print(
        f"fused_mlp_fwd P={p} ({label}): output scale {scale:.3f}; max_abs_err {max_err:.3e} "
        f"(limit {lim_max:.3e}) median_abs_err {med_err:.3e} (limit {lim_med:.3e}) kernel_ms {k_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by}) plain_ms {p_ms:.4f} library_ms null "
        "(no single PyTorch call computes the MLP chain)"
    )
    check(ok, f"fused_mlp_fwd disagrees with its plain version at P={p}")
    return dict(P=p, label=label, max_abs_err=max_err, median_abs_err=med_err, ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, output_scale=scale, x=x)


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


def check_feature_major(torch, fm, packed, x, gen, pm_ms: float) -> dict:
    """The (3, P) launch on the same points equals the point-major launch
    bit for bit (forward and dx), and its time beside the point-major one
    (the point-major launch must not have become slower: PERF.md keeps its
    earlier times)."""
    x_fm = x.T.contiguous()
    g = (torch.randn((x.shape[0],), generator=gen) / x.shape[0]).to(x.device)
    same_fwd = torch.equal(fm.fused_mlp_fwd_cuda(packed, x_fm, True),
                           fm.fused_mlp_fwd_cuda(packed, x))
    grads_fm, dx_fm = fm.fused_mlp_bwd_cuda(packed, x_fm, g, True)
    grads_pm, dx_pm = fm.fused_mlp_bwd_cuda(packed, x, g)
    same_bwd = torch.equal(dx_fm, dx_pm.T) and all(
        torch.equal(u, v) for a, b in zip(grads_fm, grads_pm) for u, v in zip(a, b))
    torch.cuda.synchronize()
    fm_ms = time_ms(torch, lambda: fm.fused_mlp_fwd_cuda(packed, x_fm, True))
    print(f"feature-major (3, P) launch at P={x.shape[0]}: forward bit-identical to the "
          f"point-major launch {same_fwd}, backward (grads and dx) {same_bwd}; forward "
          f"kernel_ms {fm_ms:.4f} (point-major {pm_ms:.4f})")
    check(same_fwd and same_bwd, "the feature-major launch differs from the point-major one")
    return dict(same_fwd=same_fwd, same_bwd=same_bwd, ms=fm_ms, point_major_ms=pm_ms)


def check_sampling_table(torch, rays, n: int = 20) -> bool:
    """build_sampling_table over the dataset's ray weights, ``n`` times on
    the same input: every table bit-identical to the first."""
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table

    first = build_sampling_table(rays.weights)
    same = all(torch.equal(first, build_sampling_table(rays.weights)) for _ in range(n - 1))
    print(f"build_sampling_table ({rays.num_rays} ray weights): {n} repeats bit-identical {same}")
    check(same, "the sampling table differs between repeats")
    return same


def packed_of(torch, fm, model):
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    return packed, sum(t.numel() * t.element_size() for t in packed)


def random_cppn(torch):
    """The CPPN the kernel checks use: random 4x128 weights with non-zero
    biases (so the bias path is exercised), on the card, and the generator
    that drew them; the limits above are set for it."""
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig

    gen = torch.Generator().manual_seed(0)
    model = CPPN(CPPNConfig(num_early_layers=4, num_filters=128), generator=gen)
    with torch.no_grad():
        for lin in model.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    return model.to(DEVICE), gen


def random_mlp(torch, fm):
    """random_cppn's weights packed for the fused-MLP kernels."""
    model, gen = random_cppn(torch)
    return (*packed_of(torch, fm, model), gen)


def kernel_phase(torch, fm, report: dict) -> list[dict]:
    """The fused-MLP kernels against their plain versions at the dense
    path's shapes."""
    packed, pbytes, gen = random_mlp(torch, fm)
    labels = dict(zip(FWD_SHAPES, ("train", "grid warmup", "grid slab", "eval")))
    fwd = [check_fwd(torch, fm, packed, p, gen, pbytes, labels[p]) for p in FWD_SHAPES]
    bwd = check_bwd(torch, fm, packed, TRAIN_P, gen, pbytes, "train")
    fwd[0]["feature_major"] = check_feature_major(torch, fm, packed, fwd[0].pop("x"), gen,
                                                  fwd[0]["ms"])
    for r in fwd[1:]:
        r.pop("x")
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


def read_counts(fm, fk, fs) -> dict:
    """Every kernel's launch count since the last reset_counts()."""
    return dict(fwd_launches=fm.fwd_launches, bwd_launches=fm.bwd_launches,
                first_k_launches=fk.launches, fused_step_launches=fs.fused_step_launches)


def reset_all(fm, fk, fs) -> None:
    for mod in (fm, fk, fs):
        mod.reset_counts()


def training_phase(torch, fm, fk, fs, ds, report: dict) -> dict:
    """60 dense-lattice steps (compact_samples=0), launch counts read around
    the run (no first-k and no whole-step launch on this path), then the
    dense step profile."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    cfg = TrainConfig(compact_samples=0, n_iters=60, display_every=30)
    steps = cfg.n_iters + 1  # the loop steps iterations 0..n_iters
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)

    reset_all(fm, fk, fs)
    res = train(cfg, ds.rays, src_pt_z=SRC_Z, verbose=True, device=DEVICE)
    torch.cuda.synchronize()
    counts = read_counts(fm, fk, fs)
    fwd_n, bwd_n = counts["fwd_launches"], counts["bwd_launches"]

    loss, pix_shape = train_loss(torch, res.state, ds.rays, cfg)
    t = res.timing
    steady_steps = cfg.n_iters  # the first step is charged to "compile"
    ms_step = 1e3 * t["step_dense"] / steady_steps
    rays_s = steady_steps * cfg.img_sample_size / t["step_dense"]
    out = dict(
        steps=steps, ms_per_step=ms_step, steady_rays_per_s=rays_s,
        rays_per_s_incl_first=res.rays_per_sec, train_loss=loss,
        heldout_psnr=res.last_psnr, best_heldout_psnr=res.best_heldout_psnr,
        **counts, grid_updates=grid_updates, evals=evals,
        timing={k: v for k, v in t.items() if isinstance(v, (int, float))},
        pix_shape=pix_shape,
    )
    print(
        f"training: {steps} steps, {ms_step:.3f} ms/step, {rays_s:.0f} rays/s steady, "
        f"train loss {loss:.6f}, held-out PSNR {res.last_psnr:.3f} dB "
        f"(best-checkpoint {res.best_heldout_psnr:.3f}), launches fwd {fwd_n} bwd {bwd_n} "
        f"first_k {counts['first_k_launches']} fused_step {counts['fused_step_launches']} "
        f"(steps {steps}, grid updates {grid_updates}, evals {evals})"
    )
    report["training"] = out
    check(math.isfinite(loss) and math.isfinite(res.last_psnr), "training loss/PSNR not finite")
    check(bwd_n == steps, f"bwd launches {bwd_n} != steps {steps}")
    check(counts["first_k_launches"] == 0 and counts["fused_step_launches"] == 0,
          "the dense split run launched the first-k or the whole-step kernel")
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


def marches_per_step(cfg, t: dict, grid, batch) -> int:
    """Rectangular marches one step of Tuning ``t`` runs (2 on a two-bucket
    march): the fused step's launches per step."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    m = _march_for(tuning_cfg(cfg, t), grid, batch.origins, batch.directions,
                   SRC_Z - cfg.outside, SRC_Z + cfg.outside)
    return 2 if isinstance(m, BucketedRays) else 1


def compacted_run(torch, fm, fk, fs, ds, cfg, label: str) -> dict:
    """One train() run with the launch counters set to 0 just before it and
    read just after; the first-k launches must equal the compacted steps
    times the launches a step of their Tuning makes. With
    ``cfg.fused_train_step == 'on'`` the fused-step launches must equal the
    rectangular marches of every step and the split backward never runs;
    otherwise the split backward runs once a step."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import train

    fused = cfg.fused_train_step == "on"
    print(f"--- {label}: {cfg.n_iters + 1} steps, march_mode={cfg.march_mode}, "
          f"fused_train_step={cfg.fused_train_step}")
    reset_all(fm, fk, fs)
    res = train(cfg, ds.rays, src_pt_z=SRC_Z, verbose=True, device=DEVICE)
    torch.cuda.synchronize()
    counts, fk_shapes = read_counts(fm, fk, fs), set(fk.shapes)
    fwd_n, bwd_n = counts["fwd_launches"], counts["bwd_launches"]
    fk_n, fs_n = counts["first_k_launches"], counts["fused_step_launches"]

    steps = res.iters_run + 1
    t = res.timing
    phases = t["steady_phases"]
    batch = sample_pixel_rays(res.state.generator, ds.rays, cfg.img_sample_size, impl="gumbel")
    per_step = [first_k_calls_per_step(fk, cfg, p, res.state.grid, batch) for p in phases]
    expected_fk = sum(n * p["steps"] for n, p in zip(per_step, phases))
    compact_steps = sum(p["steps"] for p in phases)
    rect = [marches_per_step(cfg, p, res.state.grid, batch) for p in phases]
    expected_fs = (steps - compact_steps) + sum(n * p["steps"] for n, p in zip(rect, phases))
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)
    loss, _ = train_loss(torch, res.state, ds.rays, cfg)
    out = dict(
        label=label, steps=steps, compact_steps=compact_steps, **counts,
        first_k_expected=expected_fk, fused_step_expected=expected_fs if fused else 0,
        first_k_shapes=sorted(fk_shapes), tuning_final=t["tuning_final"],
        steady_rays_per_sec=t["steady_rays_per_sec"], step_compact_s=t["step_compact"],
        step_dense_s=t["step_dense"], choose_s=t["choose"], compile_s=t["compile"],
        total_s=t["total"], pressure_fired=t["pressure_fired"],
        pressure_muted=t["pressure_muted"], decay_bounces=t["decay_bounces"],
        phases=[{**p, "first_k_per_step": n, "marches_per_step": m}
                for p, n, m in zip(phases, per_step, rect)],
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
          f"from {compact_steps} compacted steps; shapes {sorted(fk_shapes)}) fused_step {fs_n}"
          + (f" (expected {expected_fs}: the rectangular marches of {steps} steps)" if fused else "")
          + f"; steps {steps}, grid updates {grid_updates}, evals {evals}; train loss {loss:.6f}, "
          f"held-out PSNR {res.last_psnr:.3f} dB (best-checkpoint {res.best_heldout_psnr:.3f})")
    check(math.isfinite(loss) and math.isfinite(res.last_psnr), f"{label}: loss/PSNR not finite")
    if fused:
        check(bwd_n == 0, f"{label}: the split backward launched {bwd_n} times")
        check(fs_n == expected_fs, f"{label}: fused_step launches {fs_n} != expected {expected_fs}")
    else:
        check(bwd_n == steps and fs_n == 0, f"{label}: bwd launches {bwd_n} != steps {steps}")
    check(fwd_n >= (0 if fused else steps) + grid_updates + evals,
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


def compact_phase(torch, fm, fk, fs, ds, report: dict) -> dict:
    """Phase 4: compacted training at the shipped defaults and forced
    hybrid, the first-k kernel on the trained grid's masks, the fused-MLP
    kernels at the compacted point count, and the compacted step profile."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import TrainConfig
    from nerf_for_angiography_tpu_torch.training.train import _flat_positions, _march_for

    cfg = TrainConfig(n_iters=COMPACT_ITERS, display_every=100)
    main = compacted_run(torch, fm, fk, fs, ds, cfg, "shipped defaults")
    check(main["compact_steps"] > 0, "the shipped-default run never engaged the compacted stepper")
    hcfg = TrainConfig(n_iters=HYBRID_ITERS, display_every=100, march_mode="hybrid")
    hyb = compacted_run(torch, fm, fk, fs, ds, hcfg, "forced hybrid")
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
    # the forward again with the 600-step run's trained weights
    t_packed, t_pbytes = packed_of(torch, fm, state.model)
    mlp["fwd_trained"] = check_fwd(torch, fm, t_packed, p, gen, t_pbytes,
                                   f"compacted step {final}, trained weights")
    for r in mlp.values():
        r.pop("x", None)

    print(f"compacted step profile at the final Tuning {final}:")
    prof = step_profile(torch, state, ds.rays, fcfg)
    check(prof["host_waits_per_step"] == 0,
          f"the compacted step waits for the device {prof['host_waits_per_step']} times a step")
    two = two_bucket_steps(torch, fm, fk, fs, state, ds.rays, cfg, batch)
    hyb.pop("result")
    out = dict(shipped=main, hybrid=hyb, first_k=fk_rows, first_k_row=fk_row, mlp=mlp,
               profile=prof, compact_p=p, two_bucket=two, final=final)
    report["compact"] = {**out, "shipped": {k: v for k, v in main.items() if k != "result"}}
    return {**out, "batch": batch}


# a two-bucket (hybrid2k) Tuning at the shapes of a pruned grid: the chooser
# picks this march once the spans have shrunk, which a short run may not see
TWO_BUCKET = dict(mode="hybrid", k=96, w_cap=160, w_lo=48, k_lo=56)
TWO_BUCKET_STEPS = 50


def two_bucket_steps(torch, fm, fk, fs, state, rays, cfg, batch) -> dict:
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
    reset_all(fm, fk, fs)
    for _ in range(TWO_BUCKET_STEPS):
        _, metrics, _, _ = step(state, rays)
    torch.cuda.synchronize()
    counts = read_counts(fm, fk, fs)
    out = dict(tuning=TWO_BUCKET, steps=TWO_BUCKET_STEPS, **counts,
               first_k_shapes=sorted(fk.shapes),
               pressure={k: int(v) for k, v in metrics.items() if k.startswith("march/")})
    print(f"two-bucket steps {TWO_BUCKET}: {TWO_BUCKET_STEPS} steps, launches fwd "
          f"{counts['fwd_launches']} bwd {counts['bwd_launches']} first_k "
          f"{counts['first_k_launches']} (shapes {sorted(fk.shapes)}) fused_step "
          f"{counts['fused_step_launches']}, last step's pressure {out['pressure']}")
    check(counts["bwd_launches"] == TWO_BUCKET_STEPS
          and counts["first_k_launches"] == 2 * TWO_BUCKET_STEPS
          and counts["fused_step_launches"] == 0,
          "the two-bucket steps did not launch one backward, two first-k kernels and no "
          "whole-step kernel a step")
    print(f"two-bucket step profile at {TWO_BUCKET}:")
    out["profile"] = step_profile(torch, state, rays, tcfg)
    check(out["profile"]["host_waits_per_step"] == 0,
          "the two-bucket step waits for the device inside a step")
    return out


# ---------------------------------------------------------------------------
# the whole-step kernel (fused_train_step) and feature_major_mlp
# ---------------------------------------------------------------------------

LATTICE = dict(mode="lattice", k=160, w_cap=0, w_lo=0, k_lo=0)


def march_blocks(torch, cfg, grid, batch) -> dict:
    """The fused step's inputs at the training path's shapes, from the
    marches of the trained grid on one batch: the dense lattice, the
    lattice at k = 160 and the two buckets of TWO_BUCKET. Each is (o, d,
    t_mid, mask, targets), contiguous."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    o, d, tgt = batch.origins, batch.directions, batch.pixel_values

    def block(m, oo, dd, tt):
        t_mid = ((m.t_starts + m.t_ends) * 0.5).contiguous()
        return tuple(a.contiguous() for a in (oo, dd, t_mid, m.mask, tt))

    out = {}
    dense = _march_for(dataclasses.replace(cfg, compact_samples=0), grid, o, d, near, far)
    out["dense"] = block(dense, o, d, tgt)
    lat = _march_for(tuning_cfg(cfg, LATTICE), grid, o, d, near, far)
    out[f"lattice k={LATTICE['k']}"] = block(lat, o, d, tgt)
    two = _march_for(tuning_cfg(cfg, TWO_BUCKET), grid, o, d, near, far)
    check(isinstance(two, BucketedRays), f"{TWO_BUCKET} does not march two buckets")
    o_s, d_s, t_s = (a.index_select(0, two.perm) for a in (o, d, tgt))
    cut = two.lo.t_starts.shape[0]
    out["two-bucket lo"] = block(two.lo, o_s[:cut], d_s[:cut], t_s[:cut])
    out["two-bucket hi"] = block(two.hi, o_s[cut:], d_s[cut:], t_s[cut:])
    return out


def split_pair(torch, fm, model, o, d, t_mid, mask, tgt, kw):
    """The same function through the split path a step runs without the
    whole-step kernel: the fused-MLP forward kernel, the PyTorch composite
    (sigmoid, prune_mask, Beer-Lambert, loss), autograd, the fused-MLP
    backward kernel. Returns the parameter gradients."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import prune_mask

    plist = fm.cppn_params_to_list(model)
    params = [t for pair in plist for t in pair]
    s = kw["input_scale"]
    x = ((o[:, None, :] + d[:, None, :] * t_mid[..., None]) * s).reshape(-1, 3)
    sigma = torch.sigmoid(fm.fused_mlp_raw(plist, x)).reshape(t_mid.shape)
    dists = torch.full_like(t_mid, kw["step"])
    keep = prune_mask(sigma, dists, mask, 0.0, kw["early_stop_eps"])
    pixel = torch.exp(-(sigma * keep * dists).sum(-1))
    loss = ((pixel - tgt) ** 2).sum() / kw["n_rays_loss"]
    return torch.autograd.grad(loss, params)


def grad_norm_errs(g_k, g_p) -> list[float]:
    """Each gradient's max abs difference normalised by the max of g_p's,
    in plist order (W_0, b_0, W_1, ...)."""
    return [float((a - b.reshape(a.shape)).abs().max()) / max(float(b.abs().max()), 1e-30)
            for pk, pp in zip(g_k, g_p) for a, b in zip(pk, pp)]


def fs_compare(torch, got, want) -> dict:
    """Pixels (max abs, median abs) and every gradient normalised by the
    plain version's max."""
    (px_k, g_k), (px_p, g_p) = got, want
    err = (px_k - px_p).abs()
    norm = grad_norm_errs(g_k, g_p)
    names = [f"{w}_{i}" for i in range(len(g_k)) for w in ("W", "b")]
    finite = bool(torch.isfinite(px_k).all()) and all(
        bool(torch.isfinite(t).all()) for pair in g_k for t in pair)
    return dict(pix_max=float(err.max()), pix_median=float(err.median()), grad_norm=max(norm),
                grad_norm_worst=names[norm.index(max(norm))],
                max_abs_err=max(float(err.max()), max(
                    float((a - b.reshape(a.shape)).abs().max())
                    for pk, pp in zip(g_k, g_p) for a, b in zip(pk, pp))),
                finite=finite)


def eps_tie_dist(torch, fm, packed, o, d, t_mid, mask, kw):
    """Per ray, the smallest |T / eps - 1| over its active samples of the
    plain forward's exclusive transmittance T = exp(-sum of sigma step mask
    before the sample)."""
    r, k = t_mid.shape
    s, step = kw["input_scale"], kw["step"]
    x = ((o * s)[:, None, :] + (d * s)[:, None, :] * t_mid[..., None]).reshape(-1, 3)
    _, acts = fm._forward_acts(packed, x)
    tau = torch.sigmoid(fm._head(packed, acts)).reshape(r, k) * step * mask
    t_excl = torch.exp(-(torch.cumsum(tau, dim=1) - tau))
    dist = (t_excl / kw["early_stop_eps"] - 1).abs()
    return torch.where(mask > 0, dist, torch.full_like(dist, float("inf"))).amin(dim=1)


def check_fused_step(torch, fm, fs, model, blk, kw, label: str, timed: bool) -> dict:
    """The whole-step kernel against its plain version on one march block
    (limits FS_PIX_MAX / FS_PIX_MEDIAN / FS_GRAD_NORM), two launches
    bit-identical; with ``timed``: kernel, plain and split-pair times and
    the bound."""
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    o, d, t_mid, mask, tgt = blk
    r, k = t_mid.shape
    got = fs.fused_step_grads_cuda(packed, *blk, **kw)
    again = fs.fused_step_grads_cuda(packed, *blk, **kw)
    want = fs.fused_step_grads_reference(packed, *blk, **kw)
    torch.cuda.synchronize()
    c = fs_compare(torch, got, want)
    same = torch.equal(got[0], again[0]) and all(
        torch.equal(u, v) for a, b in zip(got[1], again[1]) for u, v in zip(a, b))
    bad = (got[0] - want[0]).abs() > FS_PIX_MAX
    n_bad = int(bad.sum())
    tie = (eps_tie_dist(torch, fm, packed, *(t[bad] for t in blk[:4]), kw)
           if n_bad else torch.zeros(0))
    ties_ok = n_bad == 0 or (kw["early_stop_eps"] > 0 and n_bad <= max(1, FS_TIE_SHARE * r)
                             and bool((tie < FS_EPS_TIE).all()))
    ok = (c["finite"] and ties_ok and c["pix_median"] <= FS_PIX_MEDIAN
          and c["grad_norm"] <= FS_GRAD_NORM)
    out = dict(label=label, R=r, k=k, actives=int(mask.sum()), **c, rays_beyond=n_bad,
               deterministic=same)
    line = (f"fused_step {label} (R={r}, k={k}, P={r * k}, {out['actives']} active samples): "
            f"pixels max_abs_err {c['pix_max']:.3e} (limit {FS_PIX_MAX} except at eps ties: "
            f"{n_bad} rays beyond it"
            + (f", each within {float(tie.max()):.3e} of eps (limit {FS_EPS_TIE})" if n_bad else "")
            + f") median {c['pix_median']:.3e} (limit {FS_PIX_MEDIAN}); max normalised grad err "
            f"{c['grad_norm']:.3e} (limit {FS_GRAD_NORM}); two launches bit-identical {same}")
    if timed:
        f, nh = packed.width, packed.n_hidden
        pbytes = sum(t.numel() * t.element_size() for t in packed)
        k_ms = time_ms(torch, lambda: fs.fused_step_grads_cuda(packed, *blk, **kw))
        p_ms = time_ms(torch, lambda: fs.fused_step_grads_reference(packed, *blk, **kw),
                       reps=3, warmup=1)
        s_ms = time_ms(torch, lambda: split_pair(torch, fm, model, *blk, kw), reps=5, warmup=2)
        # one forward, the dW products and the dh products of the samples
        # this data needs (mask != 0: the others add nothing to the pixel or
        # the gradients); each input read once (rays, t_mid and mask,
        # targets, weights), pixels and gradients written once. The
        # interface bound counts every sample of the rectangle.
        nbytes = r * 7 * 4 + r * k * 8 + pbytes + r * 4 + 4 * sum(
            t.numel() for pair in got[1] for t in pair)
        b_ms, b_by = bound_ms(3 * mlp_flops(out["actives"], f, nh)[0], nbytes)
        i_ms, _ = bound_ms(3 * mlp_flops(r * k, f, nh)[0], nbytes)
        out.update(ms=k_ms, plain_ms=p_ms, split_pair_ms=s_ms, bound_ms=b_ms, bound_by=b_by,
                   interface_bound_ms=i_ms)
        line += (f"; kernel_ms {k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, the active samples; "
                 f"{i_ms:.4f} over all {r * k}) plain_ms {p_ms:.4f} split_pair_ms {s_ms:.4f} "
                 f"library_ms null (no single PyTorch call computes the train-step gradient)")
    print(line)
    check(ok, f"fused_step disagrees with its plain version: {label}")
    check(same, f"fused_step gradients differ between two launches: {label}")
    return out


def fused_wiring(torch, fm, state, batch, cfg, label: str, blks: list, kw: dict) -> dict:
    """At one trained state and batch: the fused step's loss, pixels and
    gradients against the split step's (render_rays + autograd). To locate
    the gap, both also against split_pair on the same march blocks ``blks``
    (the split composite with dists = step exactly and x = bf16((o + d·t)·s)):
    the fused step differs from split_pair in x's cast points and the keep
    sum's order, the split step from split_pair in dists."""
    from nerf_for_angiography_tpu_torch.training.train import _fused_loss_and_grads, render_rays

    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    model = state.model
    o, d, tgt = batch.origins, batch.directions, batch.pixel_values
    loss_f, px_f, _, grads_f = _fused_loss_and_grads(model, state.grid, o, d, tgt, cfg,
                                                     near, far)
    model.zero_grad(set_to_none=True)
    px_s, _, _ = render_rays(model, state.grid, o, d, cfg, near, far)
    loss_s = torch.mean((px_s - tgt) ** 2)
    loss_s.backward()
    loss_s = loss_s.detach()
    grads_s = [(lin.weight.grad.T, lin.bias.grad) for lin in model.linears()]
    c = fs_compare(torch, (px_f, grads_f), (px_s.detach(), grads_s))
    model.zero_grad(set_to_none=True)
    loss_rel = abs(float(loss_f) - float(loss_s)) / max(float(loss_s), 1e-30)
    exact = None
    for blk in blks:
        g = split_pair(torch, fm, model, *blk, kw)
        exact = g if exact is None else [a + b for a, b in zip(exact, g)]
    exact = [tuple(exact[i:i + 2]) for i in range(0, len(exact), 2)]
    vs_fused = max(grad_norm_errs(grads_f, exact))
    vs_split = max(grad_norm_errs(grads_s, exact))
    print(f"fused step vs split step ({label}): loss {float(loss_f):.6e} vs {float(loss_s):.6e} "
          f"(relative {loss_rel:.3e}, limit {WIRE_LOSS_REL}); pixels max_abs_err "
          f"{c['pix_max']:.3e} (limit {WIRE_PIX_MAX}) median {c['pix_median']:.3e} (limit "
          f"{WIRE_PIX_MEDIAN}); max normalised grad err {c['grad_norm']:.3e} (limit "
          f"{WIRE_GRAD_NORM}; layer {c['grad_norm_worst']}, layers numbered from the input); "
          f"against the split composite with dists = step exactly: fused {vs_fused:.3e}, "
          f"split {vs_split:.3e}")
    check(c["finite"] and loss_rel <= WIRE_LOSS_REL and c["pix_max"] <= WIRE_PIX_MAX
          and c["pix_median"] <= WIRE_PIX_MEDIAN and c["grad_norm"] <= WIRE_GRAD_NORM,
          f"the fused step disagrees with the split step ({label})")
    return dict(label=label, loss_rel=loss_rel, **c, exact_dists_vs_fused=vs_fused,
                exact_dists_vs_split=vs_split)


def dense_run(torch, fm, fk, fs, ds, label: str, **cfg_kw) -> dict:
    """DENSE_ITERS dense steps with the launch counters set to 0 just
    before and read just after (a dense run never launches first-k)."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    cfg = TrainConfig(compact_samples=0, n_iters=DENSE_ITERS, display_every=30, **cfg_kw)
    steps = cfg.n_iters + 1
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)
    reset_all(fm, fk, fs)
    res = train(cfg, ds.rays, src_pt_z=SRC_Z, verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    counts = read_counts(fm, fk, fs)
    ms_step = 1e3 * res.timing["step_dense"] / cfg.n_iters
    print(f"{label}: {steps} dense steps, {ms_step:.3f} ms/step, held-out PSNR "
          f"{res.last_psnr:.3f} dB (best-checkpoint {res.best_heldout_psnr:.3f}); launches fwd "
          f"{counts['fwd_launches']} bwd {counts['bwd_launches']} first_k "
          f"{counts['first_k_launches']} fused_step {counts['fused_step_launches']} (steps "
          f"{steps}, grid updates {grid_updates}, evals {evals})")
    check(math.isfinite(res.last_psnr), f"{label}: held-out PSNR not finite")
    check(counts["first_k_launches"] == 0, f"{label}: the dense run launched first-k")
    return dict(label=label, steps=steps, ms_per_step=ms_step, heldout_psnr=res.last_psnr,
                best_heldout_psnr=res.best_heldout_psnr, **counts, grid_updates=grid_updates,
                evals=evals, state=res.state)


def profile_row(p: dict) -> str:
    return (f"device {p['device_ms_per_step']:.3f} ms/step in {p['device_ops_per_step']:.1f} "
            f"ops, host issue {p['host_issue_ms_per_step']:.3f} ms/step, wall "
            f"{p['wall_ms_per_step']:.3f} ms/step, busy {p['busy_share'] or 0.0:.3f}, host "
            f"waits {p['host_waits_per_step']:.2f}/step")


def fused_step_phase(torch, fm, fk, fs, ds, tr: dict, cp: dict, report: dict) -> dict:
    """Phase 5: the whole-step kernel and feature_major_mlp."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig

    state = cp["shipped"]["result"].state
    batch = cp["batch"]
    cfg = TrainConfig(n_iters=COMPACT_ITERS, display_every=100)
    kw = dict(step=(2 * cfg.outside) / cfg.depth_samples_per_ray,
              early_stop_eps=cfg.early_stop_eps, n_rays_loss=cfg.img_sample_size,
              input_scale=state.model.config.input_scale)
    blocks = march_blocks(torch, cfg, state.grid, batch)
    rnd_model, _ = random_cppn(torch)
    shapes = {}
    for name, blk in blocks.items():
        shapes[name] = dict(
            random=check_fused_step(torch, fm, fs, rnd_model, blk, kw,
                                    f"{name}, random weights", timed=True),
            trained=check_fused_step(torch, fm, fs, state.model, blk, kw,
                                     f"{name}, trained weights", timed=False),
        )
    wiring = [fused_wiring(torch, fm, state, batch, dataclasses.replace(cfg, compact_samples=0),
                           "dense", [blocks["dense"]], kw),
              fused_wiring(torch, fm, state, batch, tuning_cfg(cfg, TWO_BUCKET), "two-bucket",
                           [blocks["two-bucket lo"], blocks["two-bucket hi"]], kw)]

    f_dense = dense_run(torch, fm, fk, fs, ds, "fused dense", fused_train_step="on")
    check(f_dense["fused_step_launches"] == f_dense["steps"] and f_dense["bwd_launches"] == 0,
          "the fused dense run did not launch one fused step a step and no split backward")
    f_main = compacted_run(torch, fm, fk, fs, ds,
                           TrainConfig(n_iters=COMPACT_ITERS, display_every=100,
                                       fused_train_step="on"), "fused shipped defaults")
    check(f_main["compact_steps"] > 0, "the fused shipped-default run never engaged compaction")
    fm_dense = dense_run(torch, fm, fk, fs, ds, "feature-major dense", feature_major_mlp=True)
    check(fm_dense["bwd_launches"] == fm_dense["steps"] and fm_dense["fused_step_launches"] == 0
          and fm_dense["fwd_launches"] >= fm_dense["steps"] + fm_dense["grid_updates"]
          + fm_dense["evals"], "the feature-major run did not launch the fused-MLP kernels")
    print(f"held-out PSNR, split vs fused_train_step='on' (same call): dense "
          f"{tr['heldout_psnr']:.3f} vs {f_dense['heldout_psnr']:.3f} dB; shipped defaults "
          f"{cp['shipped']['heldout_psnr']:.3f} vs {f_main['heldout_psnr']:.3f} dB; "
          f"feature-major dense {fm_dense['heldout_psnr']:.3f} dB")

    # the fused step profiled at the lattice and two-bucket Tunings, beside
    # the split profiles of this call
    final = cp["final"]
    profiles = {}
    for name, t, split in (("lattice", final, cp["profile"]),
                           ("two-bucket", TWO_BUCKET, cp["two_bucket"]["profile"])):
        fcfg = dataclasses.replace(tuning_cfg(cfg, t), fused_train_step="on")
        print(f"fused step profile at {name} {t}:")
        prof = step_profile(torch, f_main["result"].state, ds.rays, fcfg)
        check(prof["host_waits_per_step"] == 0, f"the fused {name} step waits for the device")
        profiles[name] = dict(tuning=t, split=split, fused=prof)
    for name, p in profiles.items():
        print(f"  {name} split: {profile_row(p['split'])}")
        print(f"  {name} fused: {profile_row(p['fused'])}")
    f_main.pop("result")
    for run in (f_dense, fm_dense):
        run.pop("state")
    out = dict(shapes=shapes, wiring=wiring, fused_dense=f_dense, fused_shipped=f_main,
               feature_major_dense=fm_dense, profiles=profiles)
    report["fused_step"] = out
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
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
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
        build_kernels(fm, fk, fs)
        rows = kernel_phase(torch, fm, report)
        ds = make_dataset(torch)
        report["sampling_table_repeats_identical"] = check_sampling_table(torch, ds.rays)
        tr = training_phase(torch, fm, fk, fs, ds, report)
        cp = compact_phase(torch, fm, fk, fs, ds, report)
        fp = fused_step_phase(torch, fm, fk, fs, ds, tr, cp, report)
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
    runs = {"dense": tr, "shipped_defaults": cp["shipped"],
            "forced_hybrid": cp["hybrid"], "two_bucket_steps": cp["two_bucket"],
            "fused_dense": fp["fused_dense"], "fused_shipped_defaults": fp["fused_shipped"],
            "feature_major_dense": fp["feature_major_dense"]}
    # every count was read around its run: a run without one is a KeyError
    by_path = {
        name: {k: r[key] for k, r in runs.items()}
        for name, key in (("fused_mlp_fwd", "fwd_launches"), ("fused_mlp_bwd", "bwd_launches"),
                          ("first_k_active", "first_k_launches"),
                          ("fused_step", "fused_step_launches"))
    }
    fk_row = cp["first_k_row"]
    rows.append(dict(
        name="first_k_active", route="cuda", source="nerf_for_angiography_tpu_torch/csrc/first_k.cu",
        replaces="nerf_for_angiography_tpu/ops/pallas/first_k.py:50", launches=0,
        max_abs_err=fk_row["max_abs_err"], ms=fk_row["ms"], plain_ms=fk_row["plain_ms"],
        bound_ms=fk_row["bound_ms"], bound_by=fk_row["bound_by"], library_ms=None,
        shape=[fk_row["R"], fk_row["w"], fk_row["k"]],
    ))
    fs_row = fp["shapes"]["dense"]["random"]
    rows.append(dict(
        name="fused_step", route="cuda",
        source="nerf_for_angiography_tpu_torch/csrc/fused_step.cu",
        replaces="nerf_for_angiography_tpu/ops/pallas/fused_step.py:79", launches=0,
        max_abs_err=fs_row["max_abs_err"], ms=fs_row["ms"], plain_ms=fs_row["plain_ms"],
        bound_ms=fs_row["bound_ms"], bound_by=fs_row["bound_by"], library_ms=None,
        split_pair_ms=fs_row["split_pair_ms"], shape=[fs_row["R"], fs_row["k"]],
        interface_bound_ms=fs_row["interface_bound_ms"],
        shapes={name: {k: v["random"][k] for k in ("R", "k", "actives", "ms", "plain_ms",
                                                    "bound_ms", "interface_bound_ms",
                                                    "split_pair_ms")}
                for name, v in fp["shapes"].items()},
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
