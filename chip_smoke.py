#!/usr/bin/env python3
"""Drive the PyTorch port (``nerf_for_angiography_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. every kernel of the training path, built from ``csrc/`` on first use,
     held against its plain PyTorch version on the card at the shapes the
     training path gives it, and timed (CUDA events);
  3. training: 60 dense-lattice steps at full width (4x128 CPPN, 75^2 rays x
     300 samples, two 128^3 grids, carve_init) on the vessel phantom, with
     the kernels' launch counters read around the run, then 16 more steps
     timed and traced with ``torch.profiler`` (device time by kernel, the
     device's busy share);
  4. one JSON line with the kernel table, the card's name/power line, and the
     final ``{"ok": true, ...}`` line.

Any failed check exits non-zero before the final line. Without CUDA, or
without the package beside this file, it exits non-zero and prints no
result. Details also go to ``smoke_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

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
            short = re.search(r"(fwd_kernel|bwd_chain_kernel|wgrad_kernel|reduce_partials)", mangled)
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


def kernel_phase(torch, fm, report: dict) -> list[dict]:
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    model = CPPN(CPPNConfig(num_early_layers=4, num_filters=128), generator=gen)
    with torch.no_grad():  # non-zero biases so the bias path is exercised
        for lin in model.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    model = model.to(dev)
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    f, nh = packed.width, packed.n_hidden
    pbytes = sum(t.numel() * t.element_size() for t in packed)

    t0 = time.perf_counter()
    fm._load_lib()
    print(f"kernel build {time.perf_counter() - t0:.1f} s; nvcc ptxas:",
          ptxas_summary(fm.build_log, f))

    rows = []
    fwd_row = None
    for p in FWD_SHAPES:
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
        line = (
            f"fused_mlp_fwd P={p}: max_abs_err {max_err:.3e} (limit {FWD_MAX_ABS}) "
            f"median_abs_err {med_err:.3e} (limit {FWD_MEDIAN_ABS}) kernel_ms {k_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}) plain_ms {p_ms:.4f} library_ms null "
            "(no single PyTorch call computes the MLP chain)"
        )
        print(line)
        report.setdefault("fwd", []).append(dict(
            P=p, max_abs_err=max_err, median_abs_err=med_err, kernel_ms=k_ms,
            bound_ms=b_ms, plain_ms=p_ms, ok=ok,
        ))
        check(ok, f"fused_mlp_fwd disagrees with its plain version at P={p}")
        if p == TRAIN_P:
            fwd_row = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        del x, got, want, err

    p = TRAIN_P
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
        f"fused_mlp_bwd P={p}: max normalised grad err {max(norm_errs[:-1]):.3e} "
        f"(limit {GRAD_NORM_MAX}); dx max normalised {norm_errs[-1]:.3e} (limit "
        f"{GRAD_NORM_MAX} except at relu ties), relative L2 {dx_rel_l2:.3e}, points beyond "
        f"the limit {int(bad.sum())} = {dx_bad_share:.2e} of all (limit {DX_BAD_SHARE:.0e}), "
        f"each with a |pre-activation| <= {float(tie_dist.max()) if len(tie_dist) else 0.0:.3e} "
        f"(a relu tie if < {RELU_TIE}); max_abs_err {max(abs_errs):.3e} "
        f"bit-deterministic {deterministic} kernel_ms {k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
        f"plain_ms {p_ms:.4f} library_ms null (no single PyTorch call computes the MLP chain)"
    )
    report["bwd"] = dict(
        P=p, norm_errs=norm_errs, abs_errs=abs_errs, deterministic=deterministic,
        dx_rel_l2=dx_rel_l2, dx_bad_share=dx_bad_share, dx_bad_tie_dist=tie_dist.tolist(),
        kernel_ms=k_ms, bound_ms=b_ms, plain_ms=p_ms,
    )
    check(finite and max(norm_errs[:-1]) <= GRAD_NORM_MAX and dx_bad_are_ties
          and dx_bad_share <= DX_BAD_SHARE,
          "fused_mlp_bwd disagrees with its plain version")
    check(deterministic, "fused_mlp_bwd is not bit-deterministic across two runs")
    bwd_row = dict(max_abs_err=max(abs_errs), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    src = "nerf_for_angiography_tpu_torch/csrc/fused_mlp.cu"
    for name, row, line in (("fused_mlp_fwd", fwd_row, 142), ("fused_mlp_bwd", bwd_row, 160)):
        rows.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"nerf_for_angiography_tpu/ops/pallas/fused_mlp.py:{line}",
            launches=0, library_ms=None, **row,
        ))
    return rows


def training_phase(torch, fm, report: dict) -> dict:
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import TrainConfig, render_rays, train

    t0 = time.perf_counter()
    ds = generate_dataset(
        make_vessel_volume(res=96),
        DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=100, img_height=100,
                      sample_outside=100.0, stratified_depths=False),
        device="cuda",
    )
    torch.cuda.synchronize()
    print(f"datagen: {ds.rays.num_rays} rays, {ds.images.shape[0]} views, "
          f"{time.perf_counter() - t0:.2f} s")
    cfg = TrainConfig(compact_samples=0, n_iters=60, display_every=30)
    steps = cfg.n_iters + 1  # the loop steps iterations 0..n_iters
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)

    fm.reset_counts()
    res = train(cfg, ds.rays, src_pt_z=1500.0, verbose=True, device="cuda")
    torch.cuda.synchronize()
    fwd_n, bwd_n = fm.fwd_launches, fm.bwd_launches

    # loss of the trained model on one training batch (not part of the run)
    st = res.state
    with torch.no_grad():
        batch = sample_pixel_rays(st.generator, ds.rays, cfg.img_sample_size, impl="gumbel")
        near, far = 1500.0 - cfg.outside, 1500.0 + cfg.outside
        pix, _, _ = render_rays(st.model, st.grid, batch.origins, batch.directions, cfg, near, far)
        loss = float(torch.mean((pix - batch.pixel_values) ** 2))
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
        pix_shape=list(pix.shape),
    )
    print(
        f"training: {steps} steps, {ms_step:.3f} ms/step, {rays_s:.0f} rays/s steady, "
        f"train loss {loss:.6f}, held-out PSNR {res.last_psnr:.3f} dB "
        f"(best-checkpoint {res.best_heldout_psnr:.3f}), launches fwd {fwd_n} bwd {bwd_n} "
        f"(steps {steps}, grid updates {grid_updates}, evals {evals})"
    )
    report["training"] = out
    check(math.isfinite(loss) and math.isfinite(res.last_psnr), "training loss/PSNR not finite")
    check(tuple(pix.shape) == (cfg.img_sample_size,) and bool(torch.isfinite(pix).all()),
          "rendered pixels have the wrong shape or are not finite")
    check(bwd_n == steps, f"bwd launches {bwd_n} != steps {steps}")
    check(fwd_n >= steps + grid_updates + evals,
          f"fwd launches {fwd_n} < steps + grid updates + evals")
    out["profile"] = step_profile(torch, res.state, ds.rays, cfg)
    return out


def step_profile(torch, state, rays, cfg, n_steps: int = 16) -> dict:
    """Where a training step's time goes: ``n_steps`` more steps of the
    trained state (one grid update among them, as in the run), timed on the
    host clock without the profiler (also the time the host takes to issue
    them, up to the final synchronize), then traced with ``torch.profiler``
    for device time by kernel and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import make_train_step

    rays = rays._replace(sampling_table=build_sampling_table(rays.weights))
    step = make_train_step(state.model, cfg, 1500.0 - cfg.outside, 1500.0 + cfg.outside)

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
    out = dict(wall_ms_per_step=wall_ms, host_issue_ms_per_step=issue_ms,
               host_waits_per_step=host_waits / n_steps,
               device_ms_per_step=device_ms,
               busy_share=device_ms / wall_ms if rows else None,
               top=[dict(ms_per_step=m, calls_per_step=c, name=k[:120]) for m, c, k in rows[:15]],
               host_top=[dict(ms_per_step=m, calls_per_step=c, name=k[:120])
                         for m, c, k in sorted(host_rows, reverse=True)[:10]])
    if not rows:
        print("step profile: the profiler saw no device time (not measured)")
        return out
    print(f"step profile ({n_steps} steps): wall {wall_ms:.3f} ms/step without the profiler "
          f"(host done issuing after {issue_ms:.3f} ms/step, {host_waits / n_steps:.2f} waits "
          f"for the device per step), "
          f"device {device_ms:.3f} ms/step, busy share {device_ms / wall_ms:.3f}")
    for m, c, k in rows[:15]:
        print(f"  {m:9.4f} ms/step  {c:6.2f} calls/step  {k[:100]}")
    print("host time by op (profiled, self CPU time):")
    for r in out["host_top"]:
        print(f"  {r['ms_per_step']:9.4f} ms/step  {r['calls_per_step']:6.2f} calls/step  "
              f"{r['name'][:100]}")
    return out


def main() -> int:
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
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {kind} count {torch.cuda.device_count()}")
    print(smi)
    report: dict = {"device": kind, "nvidia_smi": smi}
    t_all = time.perf_counter()
    try:
        rows = kernel_phase(torch, fm, report)
        tr = training_phase(torch, fm, report)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        os.makedirs(os.path.join(HERE, "smoke_out"), exist_ok=True)
        with open(os.path.join(HERE, "smoke_out", "chip_smoke.json"), "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    rows[0]["launches"] = tr["fwd_launches"]
    rows[1]["launches"] = tr["bwd_launches"]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
