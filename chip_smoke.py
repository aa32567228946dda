#!/usr/bin/env python3
"""Drive the PyTorch port (``nerf_for_angiography_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # the checks below
    python3 chip_smoke.py --determinism      # also: run-to-run reproducibility
    python3 chip_smoke.py --protocol 20000   # also: one 20k-step shipped run
    python3 chip_smoke.py --lca-protocol 20000   # also: the LCA anchor's 20k protocol
    python3 chip_smoke.py --parent DIR       # also: the parent checkout's numbers

Phases:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. every kernel library (four) built from ``csrc/`` (one nvcc per source,
     all started together), then the native host libraries, the HGMMA
     instructions of the wgmma forwards
     (kernel #1 at its 8 widths, the encoded kernel #3 at its 26 (F, KE)
     instantiations) counted in the built libraries' SASS, #3's ptxas at F =
     128, KE = 48 (no spill), and the fused-MLP
     kernels held against their plain PyTorch versions on the card at the
     dense path's shapes and timed (CUDA events): the forward at the dense,
     lattice, grid-EMA, eval and a ragged point count, its feature-major
     (3, P) launch equal to the point-major one at each; the sampling table
     built 20 times, bit-identical;
  3. dense training: 60 dense-lattice steps at full width (4x128 CPPN, 75^2
     rays x 300 samples, two 128^3 grids, carve_init) on the vessel
     phantom, the launch counters read around the run, then 16 more steps
     timed and traced with ``torch.profiler`` (device time by kernel, the
     device's busy share). Every ``train()`` run of this script steps its
     full chunks through ``make_train_chunk`` (one CUDA-graph replay a
     step) and reports the graphs it captured and its peak device memory;
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
     bit-identical, its composite scan bit-identical to a one-thread-a-ray
     scan, the shares of 16-sample tiles active by mask and by draw, timed
     beside its bound (also over the tiles it computes, with the scratch
     traffic floor), its launches profiled, and the split pair (MLP
     forward, PyTorch composite, MLP backward) for the same function; the
     fused step
     against the split step at one trained state; 60 dense and 600
     shipped-default steps with ``fused_train_step='on'`` (one launch per
     rectangular march, no split backward); the fused step profiled at the
     lattice and two-bucket Tunings; 60 dense steps with
     ``feature_major_mlp``; then the fused-MLP backward (kernel #2) on the
     gradient the split composite hands it at the trained state on the same
     four marches (share of active 16-point tiles, against its plain
     version, dx exactly 0 on skipped tiles, time beside the bound and the
     scratch traffic floor over the active tiles);
     every compacted run's pressure schedule is held to the JAX loop's;
  6. the encoded (fourier / BARF) pair: the kernels held against their plain
     versions at 4x128, L = 5 (fourier coefficients ~ N(0, 5^2); BARF at
     alpha 0, 2.7 and 5) at the path's shapes, two launches bit-identical,
     timed; 600 full-width fourier steps at the shipped defaults and 300
     BARF steps annealing alpha from 0 to 5, each with all six launch
     counters read around it; the backward at the fourier run's compacted
     point count; the encoded backward (kernel #4) on the gradient the split
     composite hands it at the fourier run's trained state, at the final
     Tuning's marches and any two-bucket Tuning the run reached (active-tile
     share below 1, the rest as for #2 above); 16 fourier compacted steps
     profiled (#3's forward, #4's chain and weight gradients and their
     share);
  7. the graph phase: for the dense, lattice, two-bucket, fused, fourier
     and BARF steps, 144 steps replayed from captured CUDA graphs against
     144 eager steps from copies of one trained state (every tensor a
     step writes, the metrics and pixels bit for bit, the launch counts
     equal, across dense grid updates, step 256 and two slab kinds
     replayed), then 16 replayed steps profiled beside 16 eager ones;
  8. kernels #2 and #4 at random g (#4: fourier at two point counts, BARF
     at each alpha); with ``--parent DIR`` also kernels #1, #2, #3, #4 and
     #6 and the split pairs of the parent checkout and of this one on the
     same inputs, each twice in fresh processes (parent, this, this,
     parent), #2's, #4's and #6's parts' device times profiled, #1's and
     #3's outputs against the parent's (#3: fourier at four point counts,
     BARF at each alpha, the trained fourier model at its compacted point
     count), #4's and #6's equal to the parent's bit for bit but for the
     sign of a zero (#6 at the four shapes with both weight sets, its
     pixels bit for bit), the parent's ptxas registers and spills (every
     kernel but #3's forward must keep them), and the parent's dense runs,
     which must equal this checkout's where #1's outputs (split run) and
     #3's (fourier run, in the first two processes) equal the parent's:
     bit for bit where both sides' Adam reads the same lr, else within
     LR_ULP_LOSS_REL and LR_ULP_PSNR_DB; and the shipped and fourier
     600-step runs' steady rays/s of both checkouts;
  9. the LCA (SDF) family: the dataset at full size (make_lca_sdf_volume
     through sdf_datagen_config: 26 views of 150x162, 2,000 depth samples a
     ray, mode='sdf'), one view's DRR on the card against the CPU's, 600
     steps at the shipped defaults with compact_engage_max 192 and the
     source at z = 4000, with log_dir and checkpoint_every (all six launch
     counters read around the run: #1 and #2 launched, #5 as often as the
     compacted steps' Tunings make it, #3, #4 and #6 never), then
     highmodel.npz read back bit-equal to the best model and re-rendering
     the reported best held-out PSNR, the grid VTKs read back equal, the
     newest resume checkpoint restored equal to what was saved, and a
     second train() on the same log_dir that resumes at step 601 without
     carving; with ``--lca-protocol N`` also the JAX LCA anchor's protocol
     for N steps (best-checkpoint held-out PSNR at least 29.3 dB, and with
     ``--protocol`` the CT run's at least 48.4 dB);
  10. evaluation and export at the JAX defaults: the CT sweep
     (``EvalConfig()``: 37x37 views of 100x100, 200 samples compacted to
     k = 96, all eight metrics with LPIPS / DISTS on the uncalibrated
     backend, GT from the vessel volume) on the best state of phase 4's
     shipped run, and the LCA sweep (``lca_eval_config()``: 37x37 views of
     150x162, the dense render, DICE / DOT 3D from the LCA volume) on the
     best state of a 2,000-step LCA protocol run (the LCA phase's
     600-step state renders black there) loaded by
     ``Reconstruction.from_run_dir`` (its render_view equal to
     render_view_pair bit for bit), each exporting the 201^3 field VTK;
     before each, one batch rendered on the card against the CPU (pixels
     and per-view metrics; a share of the compared pixels must lie inside
     (0.02, 0.98)), kernel #1 at the
     batch's and the field chunks' point counts and first-k (CT) bit for bit
     on the batch's march mask; the six launch counters read around each
     sweep (#1 once a batch and once a field chunk, #5 once a CT batch, the
     rest never); the seconds by part and peak device memory; every
     artifact read back (the CSV with JAX's header, every PNG, the summary,
     the VTK, every heatmap and per-angle JSON, the rotation videos). Where
     the card lacks PIL
     or matplotlib, the videos or the heatmap PNGs are left out (printed)
     and the cag-vis JSONs still written (``export_heatmaps``). With
     ``--lca-protocol`` also that run's best state swept at
     benchmarks/LCA.md's 9x9 / 51^3 settings, printed beside the JAX run's
     summary;
  11. the user pipeline through the entry points (``cli_phase``), in a
     temporary workspace: the two native host libraries built (phase 2's
     end) and ``python -m nerf_for_angiography_tpu_torch.cli.<name> --help``
     for datagen, train, evaluate and analyze in fresh processes; the
     datagen CLI for CT (``phantom:vessel``, 26 views of 100x100), LCA
     (``phantom:lca``, the sdf preset) and a STRUCTURED_POINTS CT file, each
     one's CSVs read back by ``load_data`` equal to the in-memory dataset bit
     for bit (the file's grid equal to transfer_func_ct of its raw values);
     the train CLI for 600 steps at the shipped defaults on the CT CSVs
     (launch counters read around it: #1, #2 and #5 launched, #3, #4 and #6
     never; its run directory written), its best held-out PSNR and steady
     rays/s printed beside an in-process train() on the in-memory dataset;
     the evaluate CLI's full 37x37 sweep of that run (#1 343 + 31, #5 343;
     1,369 metric rows, 703 per-angle JSONs held to the sweep's images,
     every other artifact read back); load_experiments reading the run;
  12. pose refinement (``pose_phase``): the vessel phantom with every view
     but the test view translated by up to 0.05 of its largest |coordinate|
     and the rays from the nominal cameras; 600 steps of the shipped
     ``TrainConfig()`` with ``pose_refine`` and pose_start 200 through
     train() (#1 launched, #2 on every step, #6 never; the view shifts
     exactly 0 before step 200 and moved by it; best held-out PSNR and
     steady rays/s beside the shipped split run's); one pose step of the
     trained pose model on the shipped run's trained grid at the lattice
     k = 160 and two-bucket Tunings, and one fourier lattice pose step with
     the fourier run's weights, each through the kernels and through their
     plain versions on the card: #5 (and #3/#4) launched, the view shifts'
     gradients within GRAD_NORM_MAX, the backward kernel's dx at the step's
     own g within check_bwd's limits, exactly 0 on the skipped tiles, its
     time beside the bound over the active tiles; 40 replayed lattice pose
     steps equal to 40 eager ones bit for bit (both AdamW groups among the
     state); the JAX recovery test at its sizes and translations (900
     steps, seeds 0-7; its two thresholds on the in-plane residuals
     averaged over the seeds, and at least as many seeds as the JAX
     package's 6 of 8 meeting both alone; each failing seed run again
     through the plain versions and with its weights one ulp off); the
     train CLI with --pose_refine on the CSVs the port writes of the pose
     dataset;
  13. the classic coarse-to-fine path (``classic_phase``) at full width
     (4x128, 75^2 rays, 300 coarse + 64 fine samples, TrainConfig()'s lr):
     400 steps with a shared and with a separate fine model (the fine loss
     halves and ends below 0.8 of an empty field's, every launch counter
     stays 0, ms a step), then 40 steps of the view branch with BARF (both
     alphas reach their basis);
  14. one JSON line with the kernel table, the card's name/power line, and the
     final ``{"ok": true, ...}`` line.

Any failed check exits non-zero before the final line. Without CUDA, or
without the package beside this file, it exits non-zero and prints no
result. Details also go to ``smoke_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor rate and
# HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FWD_SHAPES = (1_687_500, 2_097_152, 524_288, 3_000_000)  # train, grid warmup, grid slab, eval
TRAIN_P = 1_687_500  # 5625 rays x 300 samples
# kernel #1 also at the lattice k = 160 step's points and at a ragged count
# (P % 64 = 63: the last 64-point tile holds one row beyond P)
FWD1_SHAPES = FWD_SHAPES + (900_000, 640_063)
FWD1_LABELS = ("train", "grid warmup", "grid slab", "eval", "lattice k=160", "ragged")
# kernel #1 in the paired fresh processes of --parent: the dense, lattice
# and grid-EMA point counts
FWD1_PAIRED = (1_687_500, 900_000, 2_097_152, 524_288)
# kernel #2 at random g: the dense step's points and the lattice k = 160 step's
BWD_RANDOM_P = (TRAIN_P, 900_000)
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
# the dense 60-step split and fourier runs against the parent commit's where
# the two lr schedules differ by one f32 ulp at some steps, so the runs part
# by rounding alone: train loss relative and held-out PSNR in dB, about 10x
# the largest reading on an H100 80GB HBM3 (9.0e-7 relative, 1.6e-5 dB)
LR_ULP_LOSS_REL, LR_ULP_PSNR_DB = 1e-5, 2e-4
# the fused step against the split step, which forms x and the composite at
# other cast points (x rounded after scaling, dists = t_ends - t_starts): loss
# relative, pixels max abs and median abs, gradients normalised
WIRE_LOSS_REL, WIRE_PIX_MAX, WIRE_PIX_MEDIAN, WIRE_GRAD_NORM = 1e-2, 2e-2, 1e-3, 3e-2
DX_BAD_SHARE = 1e-5  # at most ~17 of 1,687,500 points
# the encoded pair (#3/#4): its input layer sums 33 products a unit where
# kernel #1's sums 3, so the two sum orders round the first layer apart
# more often and more relu ties arise downstream (2, 9 and 17 points of
# 1,687,500 in three checks of one card call, each shown a tie); every point
# beyond the dx limit must still be a relu tie
DX_BAD_SHARE_ENC = 2e-5
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
# the LCA phase (training.lca_protocol: the anchor's configuration and the
# SDF preset's source distance): 600 steps, the resume state every 300
# iterations (the loop writes it at the evals on that cadence, so the evals
# come every 300 too), then a resumed run to 660
LCA_ITERS, LCA_RESUME_ITERS, LCA_EVERY = 600, 660, 300
LCA_CPU_VIEW = 24  # the (25, 25) view, the sweep's far corner
LCA_SHAPE = (26, 162, 150, 2000)  # views, height, width, depth samples a ray
LCA_FLOOR_DB = 29.3  # the JAX anchor's 30.12 dB less its 0.8 dB plateau wobble
CT_FLOOR_DB = 48.4  # the JAX 20k protocol's band, 48.4-50.0 dB over 6 seeds
COMPACT_ITERS, HYBRID_ITERS, DENSE_ITERS = 600, 300, 60
ENC_FOURIER_ITERS, ENC_BARF_ITERS = 600, 300  # the encoded runs (phase 6)
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


def time_ms_b2b(torch, fn, n: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of the device ms a call of fn() with ``n`` calls
    enqueued back to back between two CUDA events, after warmup: the host's
    time a call overlaps the device's, where time_ms's single call between
    two events also counts the host's issue of it (tens of microseconds of
    a wrapper's checks, against a kernel of a few hundred)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def mlp_flops(p: int, f: int, nh: int, n_in: int = 3) -> tuple[float, float]:
    """(forward, backward) FLOP of the n_in -> F -> nh x (F -> F) -> 1 MLP
    over p points (n_in = 3 coordinates, or the 3 + 6L encoded features);
    backward = recompute + dW + dx/dh products."""
    fwd = 2.0 * p * (n_in * f + nh * f * f + f)
    dw = 2.0 * p * (n_in * f + nh * f * f + f)
    dh = 2.0 * p * (nh * f * f + n_in * f)
    return fwd, fwd + dw + dh


def min_abs_preact(torch, packed, x):
    """Per point, the smallest |pre-activation| over every relu of the plain
    forward (same cast points as the kernels); x is the (P, 3) input or an
    encoded (P, KE) block."""
    h = x.to(torch.bfloat16).float()
    weights = [packed.w_in[:, : x.shape[1]]] + list(packed.w_hid)
    dist = torch.full((x.shape[0],), float("inf"), device=x.device)
    for w, b in zip(weights, packed.bias):
        z = h @ w.float().T + b
        dist = torch.minimum(dist, z.abs().amin(dim=1))
        h = torch.relu(z).to(torch.bfloat16).float()
    return dist


# the anonymous namespace in a mangled kernel name, which differs between
# two builds of one source in two directories
ANON_NS = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def ptxas_table(log: str) -> dict:
    """Every kernel of nvcc's -Xptxas -v report: (registers, stack frame,
    spill-store and spill-load bytes) by mangled name (anonymous namespace
    normalised)."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            cur = ANON_NS.sub("ANON", ln.split("'")[1])
            out[cur] = [None, 0, 0, 0]
        elif cur and "bytes stack frame" in ln:
            out[cur][1:] = [int(n) for n in re.findall(r"(\d+) bytes", ln)[:3]]
        elif cur and "Used" in ln and "registers" in ln:
            out[cur][0] = int(ln.split("Used")[1].split("registers")[0])
    return {k: tuple(v) for k, v in out.items()}


def ptxas_summary(log: str, width: int, ke: int | None = None) -> str:
    """Registers of each kernel at this width (and encoded input width ke;
    and of the width-free ones), any kernel that spills with its spill-store
    bytes, and the stack frames of the kept ones, from nvcc's -Xptxas -v
    report."""
    if not log:
        return "(built earlier in this process)"
    regs, frames, spills = {}, {}, []
    for mangled, (n_regs, frame, stores, _) in ptxas_table(log).items():
        short = re.search(
            r"(wgmma_enc_fwd_kernel|wgmma_march_fwd_kernel|wgmma_fwd_kernel|fwd_kernel"
            r"|bwd_chain_kernel|wgrad_kernel|reduce_partials|first_k_kernel|tile_list_kernel"
            r"|scan_serial_kernel|scan_kernel)",
            mangled)
        width_arg = re.search(r"ILi(\d+)E", mangled)
        # the encoded input width: an EncX template argument, or the second
        # int argument of kernel #3's wgmma_enc_fwd_kernel<F, KE>
        ke_arg = re.search(r"EncXILi(\d+)E|enc_fwd_kernelILi\d+ELi(\d+)E", mangled)
        cur = (short.group(1) if short else mangled) + (
            f"<{width_arg.group(1)}"
            + (f",KE{ke_arg.group(1) or ke_arg.group(2)}" if ke_arg else "") + ">"
            if width_arg else "")
        regs[cur], frames[cur] = n_regs, frame
        if stores > 0:
            spills.append(f"{cur} ({stores} B of spill stores)")
    want = f"<{width}" + (f",KE{ke}" if ke else "") + ">"
    keep = [k for k in regs if want in k or "<" not in k]
    return ("; ".join(f"{k} {regs[k]} registers, {frames[k]} B stack frame" for k in keep)
            + f"; spills: {', '.join(spills) or 'none'}")


def sass_hgmma(so_path: str) -> dict:
    """HGMMA instructions in each kernel of a built library's SASS
    (cuobjdump -sass, beside nvcc), by mangled name."""
    from nerf_for_angiography_tpu_torch.ops.kernels.build import nvcc

    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          timeout=300).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            cur = ANON_NS.sub("ANON", ln.split("Function : ")[1].strip())
            out[cur] = 0
        elif cur and "HGMMA" in ln:
            out[cur] += 1
    return out


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def build_kernels(fm, fk, fs, fe) -> dict:
    """Build every kernel library at once: one nvcc per source, started
    together (each library builds under its own lock); count the wgmma
    forward's HGMMA instructions (every width must have some). Returns
    each library's ptxas table and the HGMMA counts."""
    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    mods = (fm, fk, fs, fe)
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = [(mod, ex.submit(timed, mod._load_lib)) for mod in mods]
        secs = [(mod, f.result()) for mod, f in futs]
    print(f"kernel builds {time.perf_counter() - t0:.1f} s in parallel ("
          + ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]} {s:.1f} s" for mod, s in secs) + ")")
    print("nvcc ptxas fused_mlp:", ptxas_summary(fm.build_log, 128))
    print("nvcc ptxas first_k:", ptxas_summary(fk.build_log, 0))
    print("nvcc ptxas fused_step:", ptxas_summary(fs.build_log, 128))
    print("nvcc ptxas fused_mlp_enc:", ptxas_summary(fe.build_log, 128, ke=48))
    for mod in mods:
        for ln in mod.build_log.splitlines():
            if "Performance Loss" in ln or "wgmma" in ln.lower() and "warning" in ln.lower():
                print(f"nvcc {mod.__name__.rsplit('.', 1)[-1]}: {ln.strip()}")
    hg = {k: v for k, v in sass_hgmma(fm._lib._name).items() if "wgmma_fwd_kernel" in k}
    wide = [v for k, v in hg.items() if "ILi128E" in k]
    print(f"HGMMA instructions in the wgmma forward's SASS (fused_mlp library): "
          f"{sum(hg.values())} over its {len(hg)} widths, {wide[0] if wide else 0} at F=128")
    check(len(hg) == 8 and all(v > 0 for v in hg.values()),
          "the wgmma forward's SASS holds no HGMMA instruction at some width")
    # kernel #3: the encoded library's forward at its 26 (F, KE) instantiations
    hg_enc = {k: v for k, v in sass_hgmma(fe._lib._name).items() if "wgmma_enc_fwd_kernel" in k}
    enc_wide = [v for k, v in hg_enc.items() if "ILi128ELi48E" in k]
    print(f"HGMMA instructions in the encoded forward's SASS (fused_mlp_enc library): "
          f"{sum(hg_enc.values())} over its {len(hg_enc)} (F, KE) instantiations, "
          f"{enc_wide[0] if enc_wide else 0} at F=128, KE=48")
    check(len(hg_enc) == 26 and all(v > 0 for v in hg_enc.values()),
          "the encoded forward's SASS holds no HGMMA instruction at some (F, KE)")
    enc_ptxas = enc_fwd_ptxas(ptxas_table(fe.build_log))
    if enc_ptxas:
        print(f"ptxas wgmma_enc_fwd_kernel at F=128, KE=48 (registers, stack frame, spill "
              f"stores, spill loads): {enc_ptxas}")
        check(enc_ptxas[2] == 0 and enc_ptxas[3] == 0,
              "kernel #3 spills at F=128, KE=48")
    return dict(hgmma=hg, hgmma_total=sum(hg.values()), hgmma_enc=hg_enc,
                hgmma_enc_total=sum(hg_enc.values()), enc_fwd_ptxas=enc_ptxas,
                ptxas={mod.__name__.rsplit(".", 1)[-1]: ptxas_table(mod.build_log)
                       for mod in mods})


def enc_fwd_ptxas(table: dict):
    """Kernel #3's (registers, stack frame, spill stores, spill loads) at F =
    128, KE = 48 from the encoded library's ptxas table; None without a
    report (an earlier build was loaded)."""
    found = [v for k, v in table.items() if "wgmma_enc_fwd_kernelILi128ELi48E" in k]
    return tuple(found[0]) if found else None


def mlp_pair(fm, packed, enc=None) -> dict:
    """The kernel and plain callables of the fused-MLP pair (kernels #1/#2),
    or with ``enc = (fe, a, w)`` of the encoded pair (#3/#4) at the encoding
    arrays (a, w). ``bwd``/``bwd_ref`` return (the gradients in a flat list,
    for the encoded pair ending with dA, held like a gradient; dx);
    ``first`` gives the block the first layer multiplies (for relu ties);
    ``n_in`` the input features the function multiplies; ``fwd_fm`` (the
    fused-MLP pair only) the feature-major launch on a (3, P) block."""
    if enc is None:
        def flat(out):
            grads, dx = out
            return [t for pair in grads for t in pair], dx

        return dict(
            name="fused_mlp", n_in=3, first=lambda x: x, dx_bad_share=DX_BAD_SHARE,
            fwd=lambda x: fm.fused_mlp_fwd_cuda(packed, x),
            fwd_fm=lambda x_fm: fm.fused_mlp_fwd_cuda(packed, x_fm, True),
            fwd_ref=lambda x: fm.fused_mlp_fwd_reference(packed, x),
            bwd=lambda x, g: flat(fm.fused_mlp_bwd_cuda(packed, x, g)),
            bwd_ref=lambda x, g: flat(fm.fused_mlp_bwd_reference(packed, x, g)),
        )
    fe, a, w = enc

    def flat_enc(out):
        grads, da, dx = out
        return [t for pair in grads for t in pair] + [da], dx

    return dict(
        name="fused_mlp_enc", n_in=3 + 2 * a.shape[0], dx_bad_share=DX_BAD_SHARE_ENC,
        first=lambda x: fe.encode(x, a, w, packed.w_in.shape[1])[0],
        fwd=lambda x: fe.fused_mlp_enc_fwd_cuda(packed, a, w, x),
        fwd_ref=lambda x: fe.fused_mlp_enc_fwd_reference(packed, a, w, x),
        bwd=lambda x, g: flat_enc(fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)),
        bwd_ref=lambda x, g: flat_enc(fe.fused_mlp_enc_bwd_reference(packed, a, w, x, g)),
    )


def check_fwd(torch, fm, packed, p: int, gen, pbytes: int, label: str, enc=None) -> dict:
    """The forward kernel against its plain version at P = p, two launches
    bit-identical, the feature-major launch (kernel #1) equal to the
    point-major one, timed (the encoded pair's with ``enc``, see mlp_pair)."""
    ops = mlp_pair(fm, packed, enc)
    f, nh = packed.width, packed.n_hidden
    dev = torch.device(DEVICE)
    x = (torch.rand((p, 3), generator=gen) * 2.0 - 1.0).to(dev)
    got = ops["fwd"](x)
    again = ops["fwd"](x)
    fm_same = torch.equal(got, ops["fwd_fm"](x.T.contiguous())) if "fwd_fm" in ops else None
    want = ops["fwd_ref"](x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, med_err = float(err.max()), float(err.median())
    scale = max(1.0, float(want.abs().max()))
    lim_max, lim_med = FWD_MAX_REL * scale, FWD_MEDIAN_REL * scale
    same = torch.equal(got, again)
    ok = bool(torch.isfinite(got).all()) and max_err <= lim_max and med_err <= lim_med
    k_ms = time_ms(torch, lambda: ops["fwd"](x))
    b2b_ms = time_ms_b2b(torch, lambda: ops["fwd"](x))
    p_ms = time_ms(torch, lambda: ops["fwd_ref"](x), reps=5, warmup=1)
    b_ms, b_by = bound_ms(mlp_flops(p, f, nh, ops["n_in"])[0], p * 3 * 4 + p * 4 + pbytes)
    print(
        f"{ops['name']}_fwd P={p} ({label}): output scale {scale:.3f}; max_abs_err {max_err:.3e} "
        f"(limit {lim_max:.3e}) median_abs_err {med_err:.3e} (limit {lim_med:.3e}) "
        f"bit-identical launches {same} "
        + ("" if fm_same is None else f"feature-major launch equal {fm_same} ")
        + f"kernel_ms {k_ms:.4f} (back to back {b2b_ms:.4f}) bound_ms {b_ms:.4f} ({b_by}) "
        f"plain_ms {p_ms:.4f} library_ms null (no single PyTorch call computes the MLP chain)"
    )
    check(ok, f"{ops['name']}_fwd disagrees with its plain version at P={p} ({label})")
    check(same, f"{ops['name']}_fwd differs between two launches at P={p} ({label})")
    check(fm_same is not False,
          f"{ops['name']}_fwd's feature-major launch differs from the point-major one at P={p}")
    return dict(P=p, label=label, max_abs_err=max_err, median_abs_err=med_err, ms=k_ms,
                ms_back_to_back=b2b_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                output_scale=scale, deterministic=same, feature_major_equal=fm_same, x=x)


def check_bwd(torch, fm, packed, p: int, gen, pbytes: int, label: str, enc=None,
              xg=None) -> dict:
    """The backward kernel against its plain version at P = p (parameter
    grads normalised, dx per point except relu ties), bit-determinism, and
    its time (the encoded pair's with ``enc``, dA held like a gradient), on
    random x and g, or on ``xg = (x, g)``."""
    ops = mlp_pair(fm, packed, enc)
    f, nh = packed.width, packed.n_hidden
    dev = torch.device(DEVICE)
    if xg is None:
        x = (torch.rand((p, 3), generator=gen) * 2.0 - 1.0).to(dev)
        g = (torch.randn((p,), generator=gen) / p).to(dev)
    else:
        x, g = xg
    grads_k, dx_k = ops["bwd"](x, g)
    grads_p, dx_p = ops["bwd_ref"](x, g)
    grads_k2, dx_k2 = ops["bwd"](x, g)
    torch.cuda.synchronize()
    flat_k = grads_k + [dx_k]
    flat_p = grads_p + [dx_p]
    flat_k2 = grads_k2 + [dx_k2]
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
    # below the pair's DX_BAD_SHARE(_ENC) of all
    ddx = (dx_k - dx_p).abs()
    dx_rel_l2 = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    bad = (ddx > GRAD_NORM_MAX * dx_p.abs().max()).any(dim=1)
    dx_bad_share = float(bad.float().mean())
    tie_dist = min_abs_preact(torch, packed, ops["first"](x[bad]))
    dx_bad_are_ties = bool((tie_dist < RELU_TIE).all())
    deterministic = all(torch.equal(a, b) for a, b in zip(flat_k, flat_k2))
    finite = all(bool(torch.isfinite(t).all()) for t in flat_k)
    k_ms = time_ms(torch, lambda: ops["bwd"](x, g))
    p_ms = time_ms(torch, lambda: ops["bwd_ref"](x, g), reps=5, warmup=1)
    grad_bytes = sum(t.numel() * 4 for t in flat_k[:-1])
    b_ms, b_by = bound_ms(mlp_flops(p, f, nh, ops["n_in"])[1],
                          p * 3 * 4 + p * 4 + p * 3 * 4 + pbytes + grad_bytes)
    print(
        f"{ops['name']}_bwd P={p} ({label}): max normalised grad err {max(norm_errs[:-1]):.3e} "
        f"(limit {GRAD_NORM_MAX}"
        + (f"; dA {norm_errs[-2]:.3e}" if enc is not None else "")
        + f"); dx max normalised {norm_errs[-1]:.3e} (limit "
        f"{GRAD_NORM_MAX} except at relu ties), relative L2 {dx_rel_l2:.3e}, points beyond "
        f"the limit {int(bad.sum())} = {dx_bad_share:.2e} of all "
        f"(limit {ops['dx_bad_share']:.0e}), "
        f"each with a |pre-activation| <= {float(tie_dist.max()) if len(tie_dist) else 0.0:.3e} "
        f"(a relu tie if < {RELU_TIE}); max_abs_err {max(abs_errs):.3e} "
        f"bit-deterministic {deterministic} kernel_ms {k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
        f"plain_ms {p_ms:.4f} library_ms null (no single PyTorch call computes the MLP chain)"
    )
    check(finite and max(norm_errs[:-1]) <= GRAD_NORM_MAX and dx_bad_are_ties
          and dx_bad_share <= ops["dx_bad_share"],
          f"{ops['name']}_bwd disagrees with its plain version at P={p} ({label})")
    check(deterministic, f"{ops['name']}_bwd is not bit-deterministic across two runs")
    return dict(P=p, label=label, max_abs_err=max(abs_errs), norm_errs=norm_errs,
                dx_rel_l2=dx_rel_l2, dx_bad_share=dx_bad_share, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, deterministic=deterministic)


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
    labels = dict(zip(FWD1_SHAPES, FWD1_LABELS))
    fwd = [check_fwd(torch, fm, packed, p, gen, pbytes, labels[p]) for p in FWD_SHAPES]
    bwd = check_bwd(torch, fm, packed, TRAIN_P, gen, pbytes, "train")
    # kernel #1 at the shapes added for its wgmma redesign, drawn after the
    # earlier checks' inputs
    fwd += [check_fwd(torch, fm, packed, p, gen, pbytes, labels[p])
            for p in FWD1_SHAPES if p not in FWD_SHAPES]
    fwd[0]["feature_major"] = check_feature_major(torch, fm, packed, fwd[0].pop("x"), gen,
                                                  fwd[0]["ms"])
    for r in fwd[1:]:
        r.pop("x")
    report["fwd"], report["bwd"] = fwd, bwd
    src = "nerf_for_angiography_tpu_torch/csrc/"
    rows = []
    for name, r, line, file in (("fused_mlp_fwd", fwd[0], 142, "mlp_wgmma.cuh"),
                                ("fused_mlp_bwd", bwd, 160, "fused_mlp.cu")):
        rows.append(dict(
            name=name, route="cuda", source=src + file,
            replaces=f"nerf_for_angiography_tpu/ops/pallas/fused_mlp.py:{line}",
            launches=0, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        ))
    rows[0]["ms_back_to_back"] = fwd[0]["ms_back_to_back"]
    rows[0]["shapes"] = {r["label"]: {k: r[k] for k in ("P", "ms", "ms_back_to_back", "plain_ms",
                                                       "bound_ms", "max_abs_err",
                                                       "median_abs_err", "feature_major_equal")}
                         for r in fwd}
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


def train_loss(torch, state, rays, cfg, src_z: float = SRC_Z) -> tuple[float, list]:
    """Loss of the trained model on one training batch (not part of the
    run), and the rendered pixels' shape."""
    from nerf_for_angiography_tpu_torch.models import barf_alpha_schedule
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import render_rays

    dense = dataclasses.replace(cfg, compact_samples=0)
    alpha = (barf_alpha_schedule(state.step, cfg.pos_enc_basis, cfg.barf_start, cfg.barf_stop)
             if cfg.pos_enc == "barf" else 0.0)
    with torch.no_grad():
        batch = sample_pixel_rays(state.generator, rays, cfg.img_sample_size, impl="gumbel")
        near, far = src_z - cfg.outside, src_z + cfg.outside
        pix, _, _ = render_rays(state.model, state.grid, batch.origins, batch.directions,
                                dense, near, far, alpha)
        loss = float(torch.mean((pix - batch.pixel_values) ** 2))
    check(tuple(pix.shape) == (cfg.img_sample_size,) and bool(torch.isfinite(pix).all()),
          "rendered pixels have the wrong shape or are not finite")
    return loss, list(pix.shape)


def read_counts(fm, fk, fs) -> dict:
    """Every kernel's launch count since the last reset_counts(), the
    encoded pair's (#3/#4) among them."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe

    return dict(fwd_launches=fm.fwd_launches, bwd_launches=fm.bwd_launches,
                first_k_launches=fk.launches, fused_step_launches=fs.fused_step_launches,
                enc_fwd_launches=fe.enc_fwd_launches, enc_bwd_launches=fe.enc_bwd_launches)


def reset_all(fm, fk, fs) -> None:
    """Set all six launch counters to 0."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe

    for mod in (fm, fk, fs, fe):
        mod.reset_counts()


def check_no_enc(counts: dict, label: str) -> None:
    """A run of a pos_enc 'none' model never launches the encoded pair."""
    check(counts["enc_fwd_launches"] == 0 and counts["enc_bwd_launches"] == 0,
          f"{label}: the encoded kernels launched on a pos_enc 'none' run")


def training_phase(torch, fm, fk, fs, ds, report: dict) -> dict:
    """60 dense-lattice steps (compact_samples=0), launch counts read around
    the run (no first-k and no whole-step launch on this path), then the
    dense step profile."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    cfg = TrainConfig(compact_samples=0, n_iters=DENSE_ITERS, display_every=30)
    steps = cfg.n_iters + 1  # the loop steps iterations 0..n_iters
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)

    reset_all(fm, fk, fs)
    with recorded_chunks() as chunks:
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
    out["graphs"] = sum(c.captures for c in chunks)
    print(
        f"training: {steps} steps ({out['graphs']} CUDA graphs captured), {ms_step:.3f} ms/step, "
        f"{rays_s:.0f} rays/s steady, "
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
    check_no_enc(counts, "dense")
    check(fwd_n >= steps + grid_updates + evals,
          f"fwd launches {fwd_n} < steps + grid updates + evals")
    out["profile"] = step_profile(torch, res.state, ds.rays, cfg)
    return out


# chunk calls of 16 steps that warm a replayed-step profile: 128 steps meet
# every grid-update kind (none, dense or each of 4 slabs) at least twice, so
# each kind's graph is captured before the timed steps
GRAPH_WARM_CALLS = 8


def step_profile(torch, state, rays, cfg, n_steps: int = 16, graph: bool = False) -> dict:
    """Where a training step's time goes: ``n_steps`` more steps of the
    trained state at ``cfg`` (one grid update among them, as in the run),
    timed on the host clock without the profiler (also the time the host
    takes to issue them, up to the final synchronize), then traced with
    ``torch.profiler`` for device time by kernel, the device's busy share
    and the host's waits for the device (stream syncs, device-to-host
    copies). With ``graph`` the steps are one make_train_chunk call, each
    step a replay of its captured CUDA graph (warmed by GRAPH_WARM_CALLS
    calls first); else the eager step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import make_train_chunk, make_train_step

    rays = rays._replace(sampling_table=build_sampling_table(rays.weights))
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    if graph:
        chunk = make_train_chunk(state.model, cfg, near, far, n_steps)

        def issue():
            chunk(state, rays)
    else:
        step = make_train_step(state.model, cfg, near, far)

        def issue():
            for _ in range(n_steps):
                step(state, rays)

    def run() -> float:
        t0 = time.perf_counter()
        issue()
        issued = time.perf_counter()
        torch.cuda.synchronize()
        return issued - t0

    for _ in range(GRAPH_WARM_CALLS if graph else 1):  # warm
        run()
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
    out = dict(graph=graph, graphs=chunk.captures if graph else 0,
               wall_ms_per_step=wall_ms, host_issue_ms_per_step=issue_ms,
               host_waits_per_step=host_waits / n_steps,
               device_ms_per_step=device_ms, device_ops_per_step=launches,
               busy_share=device_ms / wall_ms if rows else None,
               top=[dict(ms_per_step=m, calls_per_step=c, name=k[:120]) for m, c, k in rows[:15]],
               host_top=[dict(ms_per_step=m, calls_per_step=c, name=k[:120])
                         for m, c, k in sorted(host_rows, reverse=True)[:10]])
    if not rows:
        print("step profile: the profiler saw no device time (not measured)")
        return out
    print(f"step profile ({n_steps} {'replayed' if graph else 'eager'} steps): wall "
          f"{wall_ms:.3f} ms/step without the profiler "
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


def first_k_calls_per_step(fk, cfg, t: dict, grid, batch, src_z: float = SRC_Z) -> int:
    """First-k launches one step of Tuning ``t`` makes: read off one march
    of that Tuning on a training batch (outside every counted run)."""
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    fk.reset_counts()
    _march_for(tuning_cfg(cfg, t), grid, batch.origins, batch.directions,
               src_z - cfg.outside, src_z + cfg.outside)
    return fk.launches


def marches_per_step(cfg, t: dict, grid, batch, src_z: float = SRC_Z) -> int:
    """Rectangular marches one step of Tuning ``t`` runs (2 on a two-bucket
    march): the fused step's launches per step."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    m = _march_for(tuning_cfg(cfg, t), grid, batch.origins, batch.directions,
                   src_z - cfg.outside, src_z + cfg.outside)
    return 2 if isinstance(m, BucketedRays) else 1


def compacted_run(torch, fm, fk, fs, ds, cfg, label: str, src_z: float = SRC_Z,
                  **train_kw) -> dict:
    """One train() run with all six launch counters set to 0 just before it
    and read just after; the first-k launches must equal the compacted steps
    times the launches a step of their Tuning makes. With
    ``cfg.fused_train_step == 'on'`` the fused-step launches must equal the
    rectangular marches of every step and the split backward never runs;
    otherwise the split backward runs once a step: kernel #2, or for an
    encoded model kernel #4, whose forward #3 then launches exactly once a
    step, once a grid pass and once an eval (every_n_step_pair makes one
    sigma call per update, eval one render of the held-out view), with #1,
    #2 and #6 never. ``barf_alphas`` collects every step's "barf-coarse".
    ``train_kw`` (log_dir, checkpoint_every) go to train()."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import train

    fused = cfg.fused_train_step == "on"
    encoded = cfg.pos_enc != "none"
    print(f"--- {label}: {cfg.n_iters + 1} steps, march_mode={cfg.march_mode}, "
          f"fused_train_step={cfg.fused_train_step}, pos_enc={cfg.pos_enc}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the reserved peak is this run's
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_all(fm, fk, fs)
    with (recorded_chunks() as chunks, recorded_barf_alphas() as barf_alphas,
          recorded_schedule(barf_alphas) as sched):
        res = train(cfg, ds.rays, src_pt_z=src_z, verbose=True, device=DEVICE, **train_kw)
    graphs = sum(c.captures for c in chunks)
    torch.cuda.synchronize()
    memory = dict(before_gib=mem0 / 2**30, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                  peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
    counts, fk_shapes = read_counts(fm, fk, fs), set(fk.shapes)
    fwd_n, bwd_n = counts["fwd_launches"], counts["bwd_launches"]
    fk_n, fs_n = counts["first_k_launches"], counts["fused_step_launches"]

    steps = res.iters_run + 1
    t = res.timing
    phases = t["steady_phases"]
    batch = sample_pixel_rays(res.state.generator, ds.rays, cfg.img_sample_size, impl="gumbel")
    per_step = [first_k_calls_per_step(fk, cfg, p, res.state.grid, batch, src_z)
                for p in phases]
    expected_fk = sum(n * p["steps"] for n, p in zip(per_step, phases))
    compact_steps = sum(p["steps"] for p in phases)
    rect = [marches_per_step(cfg, p, res.state.grid, batch, src_z) for p in phases]
    expected_fs = (steps - compact_steps) + sum(n * p["steps"] for n, p in zip(rect, phases))
    grid_updates = sum(1 for s in range(steps) if s % cfg.grid_update_every == 0)
    evals = sum(1 for s in range(steps) if s % cfg.display_every == 0)
    loss, _ = train_loss(torch, res.state, ds.rays, cfg, src_z)
    out = dict(
        label=label, steps=steps, compact_steps=compact_steps, **counts,
        first_k_expected=expected_fk, fused_step_expected=expected_fs if fused else 0,
        first_k_shapes=sorted(fk_shapes), tuning_final=t["tuning_final"],
        steady_rays_per_sec=t["steady_rays_per_sec"], step_compact_s=t["step_compact"],
        step_dense_s=t["step_dense"], dense_rays=t["dense_rays"], choose_s=t["choose"],
        compile_s=t["compile"],
        total_s=t["total"], pressure_fired=t["pressure_fired"],
        pressure_muted=t["pressure_muted"], decay_bounces=t["decay_bounces"],
        phases=[{**p, "first_k_per_step": n, "marches_per_step": m}
                for p, n, m in zip(phases, per_step, rect)],
        train_loss=loss, heldout_psnr=res.last_psnr, best_heldout_psnr=res.best_heldout_psnr,
        rays_per_s_incl_first=res.rays_per_sec, grid_updates=grid_updates, evals=evals,
        barf_coarse_first=float(barf_alphas[0]), barf_coarse_last=float(barf_alphas[-1]),
        graphs=graphs, memory=memory,
    )
    print(f"{label}: final Tuning {t['tuning_final']}, steady_rays_per_sec "
          f"{t['steady_rays_per_sec']:.0f}, step_compact {t['step_compact']:.3f} s, "
          f"step_dense {t['step_dense']:.3f} s, choose {t['choose']:.3f} s, compile "
          f"{t['compile']:.3f} s, total {t['total']:.3f} s; pressure fired "
          f"{t['pressure_fired']} muted {t['pressure_muted']} decay bounces "
          f"{t['decay_bounces']}; {graphs} CUDA graphs captured; device memory "
          f"{memory['before_gib']:.3f} GiB allocated before the run, peak "
          f"{memory['peak_allocated_gib']:.3f} GiB allocated and "
          f"{memory['peak_reserved_gib']:.3f} GiB reserved")
    for p, n in zip(phases, per_step):
        print(f"  phase {p['mode']} k={p['k']} w_cap={p['w_cap']} w_lo={p['w_lo']} "
              f"k_lo={p['k_lo']}: {p['steps']} steps ({p['rays']} steady rays in "
              f"{p['wall_s']:.3f} s), {n} first-k launches per step")
    print(f"{label}: launches fwd {fwd_n} bwd {bwd_n} first_k {fk_n} (expected {expected_fk} "
          f"from {compact_steps} compacted steps; shapes {sorted(fk_shapes)}) fused_step {fs_n}"
          + (f" (expected {expected_fs}: the rectangular marches of {steps} steps)" if fused else "")
          + f" enc_fwd {counts['enc_fwd_launches']} enc_bwd {counts['enc_bwd_launches']}"
          + f"; steps {steps}, grid updates {grid_updates}, evals {evals}; train loss {loss:.6f}, "
          f"held-out PSNR {res.last_psnr:.3f} dB (best-checkpoint {res.best_heldout_psnr:.3f})"
          + (f"; barf-coarse first {out['barf_coarse_first']} last {out['barf_coarse_last']}"
             if cfg.pos_enc == "barf" else ""))
    check(math.isfinite(loss) and math.isfinite(res.last_psnr), f"{label}: loss/PSNR not finite")
    check(len(barf_alphas) == steps, f"{label}: {len(barf_alphas)} step metrics for {steps} steps")
    out["schedule"] = check_schedule(sched, cfg, label, logged=bool(train_kw.get("log_dir")),
                                     checkpoint_every=train_kw.get("checkpoint_every"))
    check(fk_n == expected_fk, f"{label}: first_k launches {fk_n} != expected {expected_fk}")
    out["result"] = res
    if encoded:
        enc_f, enc_b = counts["enc_fwd_launches"], counts["enc_bwd_launches"]
        check(fwd_n == 0 and bwd_n == 0 and fs_n == 0,
              f"{label}: an encoded run launched fused_mlp ({fwd_n}, {bwd_n}) or fused_step "
              f"({fs_n})")
        check(enc_b == steps, f"{label}: enc bwd launches {enc_b} != steps {steps}")
        check(enc_f == steps + grid_updates + evals,
              f"{label}: enc fwd launches {enc_f} != steps + grid updates + evals "
              f"= {steps + grid_updates + evals}")
        return out
    check_no_enc(counts, label)
    if fused:
        check(bwd_n == 0, f"{label}: the split backward launched {bwd_n} times")
        check(fs_n == expected_fs, f"{label}: fused_step launches {fs_n} != expected {expected_fs}")
    else:
        check(bwd_n == steps and fs_n == 0, f"{label}: bwd launches {bwd_n} != steps {steps}")
    check(fwd_n >= (0 if fused else steps) + grid_updates + evals,
          f"{label}: fwd launches {fwd_n} < steps + grid updates + evals")
    return out


@contextlib.contextmanager
def recorded_chunks():
    """Within the block, every chunk that train() makes (make_train_chunk)
    is appended to the yielded list (their ``captures`` count the CUDA
    graphs); a package without chunks yields an empty list."""
    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    chunks: list = []
    make = getattr(loop, "make_train_chunk", None)
    if make is None:
        yield chunks
        return

    def recording(*args, **kwargs):
        chunks.append(make(*args, **kwargs))
        return chunks[-1]

    loop.make_train_chunk = recording
    try:
        yield chunks
    finally:
        loop.make_train_chunk = make


@contextlib.contextmanager
def recorded_barf_alphas():
    """Within the block, every train step that train() runs (each a step of
    a chunk, eager or replayed) appends a copy of its "barf-coarse" metric (a device
    scalar, read after the run: no host wait inside it; a copy, since a
    replayed graph rewrites its outputs) to the yielded list."""
    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    seen: list = []
    make_chunk = loop.make_train_chunk

    def recorded(step):
        def run(state, rays):
            out = step(state, rays)
            seen.append(out[1]["barf-coarse"].clone())
            return out

        return run

    wrapped: list = []

    def make_chunk_recording(*args, **kwargs):
        chunk = make_chunk(*args, **kwargs)
        chunk.step = recorded(chunk.step)
        wrapped.append(chunk)
        return chunk

    loop.make_train_chunk = make_chunk_recording
    try:
        yield seen
    finally:
        loop.make_train_chunk = make_chunk
        # the wrapper holds its chunk: drop it, so the chunk and its graphs
        # are freed with the run, not by a later cyclic collection
        for chunk in wrapped:
            del chunk.step


@contextlib.contextmanager
def recorded_schedule(issued: list):
    """Within the block, the PressureTuner that train() builds records each
    observe (its boundary m, the steps issued by then = len(issued), the k
    the loop runs and whether a fire was armed just before) and each Tuning
    it engages or changes to (with the iteration)."""
    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    base = loop.PressureTuner
    log = dict(observe=[], tunings=[], k=0)

    class Recording(base):
        def observe(self, m, *stats):
            log["observe"].append((m, len(issued), log["k"], self.fire, stats[:3]))
            super().observe(m, *stats)

        def engage(self, choice, cfg):
            t = super().engage(choice, cfg)
            log["k"] = t.k
            log["tunings"].append(("engage", len(issued) - 1, dataclasses.asdict(t)))
            return t

        def retune(self, t, choice, cfg):
            t2 = super().retune(t, choice, cfg)
            log["k"] = t2.k
            if t2 != t:
                log["tunings"].append(("retune", len(issued) - 1, dataclasses.asdict(t2)))
            return t2

    loop.PressureTuner = Recording
    try:
        yield log
    finally:
        loop.PressureTuner = base


def check_schedule(log: dict, cfg, label: str, logged: bool = False,
                   checkpoint_every: int | None = None) -> dict:
    """The JAX loop's pressure latency (JAX training/loop.py:411-538): a
    full chunk's pressure reaches the tuner once the next chunk is issued
    (m + chunk + 1 steps), and at its own boundary (m + 1 steps) exactly
    where that loop drains: a logging boundary (every 100 with a log_dir),
    a re-check boundary of the k then running, an armed fire, a display
    boundary, the last iteration, or a partial chunk next. The chunk
    divides checkpoint_every too."""
    chunk = math.gcd(100, cfg.display_every)
    if checkpoint_every:
        chunk = math.gcd(chunk, checkpoint_every)
    check_every = max(chunk, -(-cfg.compact_check_every // chunk) * chunk)
    deferred = 0
    for m, issued, k, fire, _ in log["observe"]:
        recheck = check_every if k > cfg.compact_samples else cfg.display_every
        at_once = (m % recheck == 0 or fire or m % cfg.display_every == 0
                   or (logged and m % 100 == 0)
                   or m >= cfg.n_iters or m + chunk > cfg.n_iters or m % chunk != 0)
        want = m + 1 if at_once else m + chunk + 1
        deferred += not at_once
        check(issued == want, f"{label}: the pressure of the chunk ending at {m} reached the "
                              f"tuner after {issued} steps, the JAX loop's schedule says {want}")
    fired = [m for m, _, _, _, st in log["observe"] if any(v > 0 for v in st)]
    changes = [(kind, n, t["k"]) for kind, n, t in log["tunings"]]
    print(f"{label}: Tunings (kind, iteration, k) {changes}; pressure in the chunks ending at "
          f"{fired}; {len(log['observe'])} chunks observed, {deferred} of them one chunk "
          "later (the JAX loop's schedule held)")
    return dict(tunings=log["tunings"], pressure_chunks=fired,
                observed=[o[:2] for o in log["observe"]], deferred=deferred)


def fk_masks(torch, grid, cfg, batch, rows: int, w: int, src_z: float = SRC_Z):
    """(rows, w) first-k input masks from the marches of the trained grid: the
    dense lattice (w = depth) or the hybrid window mask at width w of the
    whole batch, its lo bucket or its hi bucket (the span-sorted split),
    with rows that are all zero, all one and denser than any k put first."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import (
        _span_sorted, coarse_window, hybrid_window_mask, march_rays, safe_occ_stride,
    )

    n, near, far = cfg.depth_samples_per_ray, src_z - cfg.outside, src_z + cfg.outside
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


def check_first_k(torch, fk, grid, cfg, batch, shapes, src_z: float = SRC_Z) -> list[dict]:
    """The kernel against its plain version, bit for bit, at each shape, with
    its time, the plain version's, a two-call composite's and the bound."""
    return [first_k_row(torch, fk, fk_masks(torch, grid, cfg, batch, rows, w, src_z), k)
            for rows, w, k in shapes]


def first_k_row(torch, fk, mask, k: int) -> dict:
    """The kernel against its plain version on ``mask`` (R, w) at k, bit for
    bit, with its time, the plain version's, a two-call composite's and the
    bound."""
    rows, w = mask.shape
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
    return dict(R=rows, w=w, k=k, max_abs_err=err, ms=k_ms, call_ms=call_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, interface_bound_ms=i_ms, composite_ms=c_ms,
                bytes_needed=need, bytes_interface=iface)


def compact_phase(torch, fm, fk, fs, ds, report: dict) -> dict:
    """Phase 4: compacted training at the shipped defaults and forced
    hybrid, the first-k kernel on the trained grid's masks, the fused-MLP
    kernels at the compacted point count, and the compacted step profile."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import TrainConfig
    from nerf_for_angiography_tpu_torch.training.train import _flat_positions, _march_for

    # the shipped display_every (500): between display boundaries the tuner
    # sees a settled k's full chunk once the next is issued, as in the JAX loop
    cfg = TrainConfig(n_iters=COMPACT_ITERS)
    # the state at each held-out eval, for the evaluation phase's CT sweep
    # on the run's best one
    with recorded_eval_states(torch) as eval_states:
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
    prof["bwd_kernels_ms"] = {k: sum(r["ms_per_step"] for r in prof["top"] if k in r["name"])
                              for k in ("bwd_chain_kernel", "wgrad_kernel")}
    prof["fwd_kernel_ms"] = sum(r["ms_per_step"] for r in prof["top"]
                                if "wgmma_fwd_kernel" in r["name"])
    print(f"  kernel #1 in this split step: {prof['fwd_kernel_ms']:.4f} ms/step; kernel #2: "
          f"backward chain {prof['bwd_kernels_ms']['bwd_chain_kernel']:.4f} ms/step, weight "
          f"gradients {prof['bwd_kernels_ms']['wgrad_kernel']:.4f} ms/step; {profile_row(prof)}")
    two = two_bucket_steps(torch, fm, fk, fs, state, ds.rays, cfg, batch)
    hyb.pop("result")
    out = dict(shipped=main, hybrid=hyb, first_k=fk_rows, first_k_row=fk_row, mlp=mlp,
               profile=prof, compact_p=p, two_bucket=two, final=final)
    report["compact"] = {**out, "shipped": {k: v for k, v in main.items() if k != "result"}}
    return {**out, "batch": batch, "shipped_best": eval_states[main["result"].best_iter]}


# a two-bucket (hybrid2k) Tuning at the shapes of a pruned grid: the chooser
# picks this march once the spans have shrunk, which a short run may not see
TWO_BUCKET = dict(mode="hybrid", k=96, w_cap=160, w_lo=48, k_lo=56)
TWO_BUCKET_STEPS = 50


def two_bucket_steps(torch, fm, fk, fs, state, rays, cfg, batch) -> dict:
    """TWO_BUCKET_STEPS steps of the trained state at the fixed two-bucket
    Tuning as one make_train_chunk call (replayed graphs after one eager
    step of each grid-update kind), launch counts read around them (two
    first-k launches a step), then that step's profile."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import make_train_chunk
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    tcfg = tuning_cfg(cfg, TWO_BUCKET)
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    m = _march_for(tcfg, state.grid, batch.origins, batch.directions, near, far)
    check(isinstance(m, BucketedRays), f"{TWO_BUCKET} does not march two buckets")
    chunk = make_train_chunk(state.model, tcfg, near, far, TWO_BUCKET_STEPS)
    rays = rays._replace(sampling_table=build_sampling_table(rays.weights))
    reset_all(fm, fk, fs)
    _, metrics, _, _ = chunk(state, rays)
    torch.cuda.synchronize()
    counts = read_counts(fm, fk, fs)
    out = dict(tuning=TWO_BUCKET, steps=TWO_BUCKET_STEPS, graphs=chunk.captures, **counts,
               first_k_shapes=sorted(fk.shapes),
               pressure={k: int(v) for k, v in metrics.items() if k.startswith("march/")})
    print(f"two-bucket steps {TWO_BUCKET}: {TWO_BUCKET_STEPS} steps ({chunk.captures} graphs "
          f"captured), launches fwd "
          f"{counts['fwd_launches']} bwd {counts['bwd_launches']} first_k "
          f"{counts['first_k_launches']} (shapes {sorted(fk.shapes)}) fused_step "
          f"{counts['fused_step_launches']}, last step's pressure {out['pressure']}")
    check(counts["bwd_launches"] == TWO_BUCKET_STEPS
          and counts["first_k_launches"] == 2 * TWO_BUCKET_STEPS
          and counts["fused_step_launches"] == 0,
          "the two-bucket steps did not launch one backward, two first-k kernels and no "
          "whole-step kernel a step")
    check_no_enc(counts, "two-bucket steps")
    print(f"two-bucket step profile at {TWO_BUCKET}:")
    out["profile"] = step_profile(torch, state, rays, tcfg)
    check(out["profile"]["host_waits_per_step"] == 0,
          "the two-bucket step waits for the device inside a step")
    return out


# ---------------------------------------------------------------------------
# the whole-step kernel (fused_train_step) and feature_major_mlp
# ---------------------------------------------------------------------------

LATTICE = dict(mode="lattice", k=160, w_cap=0, w_lo=0, k_lo=0)


def rect_blocks(m, o, d, tgt) -> list:
    """The rectangular marches of march ``m`` on the rays (o, d, targets):
    one block, or a BucketedRays' lo and hi buckets, each (o, d, t_mid,
    mask, targets), contiguous."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays

    def block(mm, oo, dd, tt):
        t_mid = ((mm.t_starts + mm.t_ends) * 0.5).contiguous()
        return tuple(a.contiguous() for a in (oo, dd, t_mid, mm.mask, tt))

    if not isinstance(m, BucketedRays):
        return [block(m, o, d, tgt)]
    o_s, d_s, t_s = (a.index_select(0, m.perm) for a in (o, d, tgt))
    cut = m.lo.t_starts.shape[0]
    return [block(m.lo, o_s[:cut], d_s[:cut], t_s[:cut]),
            block(m.hi, o_s[cut:], d_s[cut:], t_s[cut:])]


def march_blocks(torch, cfg, grid, batch) -> dict:
    """The fused step's inputs at the training path's shapes, from the
    marches of the trained grid on one batch: the dense lattice, the
    lattice at k = 160 and the two buckets of TWO_BUCKET (rect_blocks)."""
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    o, d, tgt = batch.origins, batch.directions, batch.pixel_values

    def blocks(c):
        return rect_blocks(_march_for(c, grid, o, d, near, far), o, d, tgt)

    out = {"dense": blocks(dataclasses.replace(cfg, compact_samples=0))[0],
           f"lattice k={LATTICE['k']}": blocks(tuning_cfg(cfg, LATTICE))[0]}
    two = blocks(tuning_cfg(cfg, TWO_BUCKET))
    check(len(two) == 2, f"{TWO_BUCKET} does not march two buckets")
    out["two-bucket lo"], out["two-bucket hi"] = two
    return out


def split_loss(torch, raw, t_mid, mask, tgt, kw):
    """The split path's composite of one march block from the raw density:
    sigmoid, prune_mask, Beer-Lambert, loss."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import prune_mask

    sigma = torch.sigmoid(raw).reshape(t_mid.shape)
    dists = torch.full_like(t_mid, kw["step"])
    keep = prune_mask(sigma, dists, mask, 0.0, kw["early_stop_eps"])
    pixel = torch.exp(-(sigma * keep * dists).sum(-1))
    return ((pixel - tgt) ** 2).sum() / kw["n_rays_loss"]


def march_x(o, d, t_mid, kw):
    """The (P, 3) MLP input of a march block, as the split step forms it."""
    return ((o[:, None, :] + d[:, None, :] * t_mid[..., None]) * kw["input_scale"]).reshape(-1, 3)


def split_pair(torch, fm, plist, o, d, t_mid, mask, tgt, kw):
    """The same function through the split path a step runs without the
    whole-step kernel, for the parameter list ``plist``: the fused-MLP
    forward kernel, the PyTorch composite, autograd, the fused-MLP backward
    kernel. Returns the parameter gradients."""
    params = [t for pair in plist for t in pair]
    raw = fm.fused_mlp_raw(plist, march_x(o, d, t_mid, kw))
    return torch.autograd.grad(split_loss(torch, raw, t_mid, mask, tgt, kw), params)


def split_raw_grad(torch, raw_fn, o, d, t_mid, mask, tgt, kw):
    """(x, g): the MLP input of a march block and the gradient the split
    composite hands the MLP backward for it (dL/draw, as FusedMLPRaw or
    FusedMLPEncRaw.backward receives it); ``raw_fn`` maps x to the raw
    density (the forward kernel of the model's path)."""
    x = march_x(o, d, t_mid, kw).contiguous()
    raw = raw_fn(x).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(split_loss(torch, raw, t_mid, mask, tgt, kw), raw)
    return x, g.contiguous()


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


def tile_count(torch, flags) -> tuple[int, int]:
    """(16-sample tiles of the flat march holding a True sample, tiles)."""
    flat = flags.reshape(-1)
    t = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 16)).reshape(-1, 16).any(dim=1)
    return int(t.sum()), t.numel()


def check_fused_step(torch, fm, fs, model, blk, kw, label: str, timed: bool) -> dict:
    """The whole-step kernel against its plain version on one march block
    (limits FS_PIX_MAX / FS_PIX_MEDIAN / FS_GRAD_NORM), two launches
    bit-identical, its composite scan bit-identical to the one-thread-a-ray
    scan on the plain forward's sigma; the shares of 16-sample tiles active
    by the mask (the forward's) and by the draw (the backward's); with
    ``timed``: kernel, plain and split-pair times, the bound, and over the
    draw-active tiles the tensor bound and the scratch traffic floor, and
    the kernel's launches profiled."""
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    o, d, t_mid, mask, tgt = blk
    r, k = t_mid.shape
    got = fs.fused_step_grads_cuda(packed, *blk, **kw)
    again = fs.fused_step_grads_cuda(packed, *blk, **kw)
    px_p, draw, xb, acts = fs.draws_reference(packed, *blk, **kw)
    want = (px_p, fm.backward_from_acts(packed, xb, acts, draw.reshape(-1))[0])
    sigma = torch.sigmoid(fm._head(packed, acts)).reshape(r, k).contiguous()
    skw = dict(step=kw["step"], early_stop_eps=kw["early_stop_eps"],
               n_rays_loss=kw["n_rays_loss"])
    scan = fs.fused_step_scan_cuda(sigma, mask, tgt, **skw)
    serial = fs.fused_step_scan_cuda(sigma, mask, tgt, serial=True, **skw)
    torch.cuda.synchronize()
    scan_same = torch.equal(scan[0], serial[0]) and torch.equal(scan[1], serial[1])
    mask_tiles, n_tiles = tile_count(torch, mask != 0)
    draw_tiles, _ = tile_count(torch, draw != 0)
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
    out = dict(label=label, R=r, k=k, actives=int((mask != 0).sum()),
               draw_actives=int((draw != 0).sum()), tiles=n_tiles,
               mask_tile_share=mask_tiles / n_tiles, draw_tile_share=draw_tiles / n_tiles, **c,
               rays_beyond=n_bad, deterministic=same, scan_equal_serial=scan_same)
    line = (f"fused_step {label} (R={r}, k={k}, P={r * k}, {out['actives']} active samples, "
            f"{out['draw_actives']} with draw != 0; tiles active by mask {mask_tiles} of "
            f"{n_tiles} ({out['mask_tile_share']:.4f}), by draw {draw_tiles} "
            f"({out['draw_tile_share']:.4f})): "
            f"pixels max_abs_err {c['pix_max']:.3e} (limit {FS_PIX_MAX} except at eps ties: "
            f"{n_bad} rays beyond it"
            + (f", each within {float(tie.max()):.3e} of eps (limit {FS_EPS_TIE})" if n_bad else "")
            + f") median {c['pix_median']:.3e} (limit {FS_PIX_MEDIAN}); max normalised grad err "
            f"{c['grad_norm']:.3e} (limit {FS_GRAD_NORM}); two launches bit-identical {same}; "
            f"scan equal to the one-thread-a-ray scan bit for bit {scan_same}")
    if timed:
        f, nh = packed.width, packed.n_hidden
        pbytes = sum(t.numel() * t.element_size() for t in packed)
        k_ms = time_ms(torch, lambda: fs.fused_step_grads_cuda(packed, *blk, **kw))
        p_ms = time_ms(torch, lambda: fs.fused_step_grads_reference(packed, *blk, **kw),
                       reps=3, warmup=1)
        plist = fm.cppn_params_to_list(model)
        s_ms = time_ms(torch, lambda: split_pair(torch, fm, plist, *blk, kw), reps=5, warmup=2)
        # one forward, the dW products and the dh products of the samples
        # this data needs (mask != 0: the others add nothing to the pixel or
        # the gradients); each input read once (rays, t_mid and mask,
        # targets, weights), pixels and gradients written once. The
        # interface bound counts every sample of the rectangle.
        nbytes = r * 7 * 4 + r * k * 8 + pbytes + r * 4 + 4 * sum(
            t.numel() for pair in got[1] for t in pair)
        b_ms, b_by = bound_ms(3 * mlp_flops(out["actives"], f, nh)[0], nbytes)
        i_ms, _ = bound_ms(3 * mlp_flops(r * k, f, nh)[0], nbytes)
        # at the kernel's grain: the forward over the mask-active tiles, the
        # recompute, dW and dh products over the draw-active tiles, and the
        # chain's scratch (activations and dz, written once and read once)
        t_ms, t_by = bound_ms(mlp_flops(16 * mask_tiles, f, nh)[0]
                              + mlp_flops(16 * draw_tiles, f, nh)[1], nbytes)
        floor = scratch_floor_ms(16 * draw_tiles, f, nh)
        parts = device_parts_ms(torch, lambda: fs.fused_step_grads_cuda(packed, *blk, **kw),
                                FS_PARTS)
        out.update(ms=k_ms, plain_ms=p_ms, split_pair_ms=s_ms, bound_ms=b_ms, bound_by=b_by,
                   interface_bound_ms=i_ms, tile_bound_ms=t_ms, tile_bound_by=t_by,
                   floor_ms=floor, parts_ms=parts)
        line += (f"; kernel_ms {k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, the active samples; "
                 f"{i_ms:.4f} over all {r * k}) plain_ms {p_ms:.4f} split_pair_ms {s_ms:.4f} "
                 f"library_ms null (no single PyTorch call computes the train-step gradient); "
                 f"over the tiles it computes (forward: by mask, backward: by draw) bound_ms "
                 f"{t_ms:.4f} ({t_by}) and scratch traffic floor {floor:.4f} ms; device ms a "
                 f"launch by part (profiled): " + parts_line(parts))
    print(line)
    check(ok, f"fused_step disagrees with its plain version: {label}")
    check(same, f"fused_step gradients differ between two launches: {label}")
    check(scan_same, f"fused_step's scan differs from the one-thread-a-ray scan: {label}")
    check(draw_tiles <= mask_tiles, f"more tiles active by draw than by mask: {label}")
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
        g = split_pair(torch, fm, fm.cppn_params_to_list(model), *blk, kw)
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
    check_no_enc(counts, label)
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
                                     f"{name}, trained weights", timed=True),
        )
    wiring = [fused_wiring(torch, fm, state, batch, dataclasses.replace(cfg, compact_samples=0),
                           "dense", [blocks["dense"]], kw),
              fused_wiring(torch, fm, state, batch, tuning_cfg(cfg, TWO_BUCKET), "two-bucket",
                           [blocks["two-bucket lo"], blocks["two-bucket hi"]], kw)]

    f_dense = dense_run(torch, fm, fk, fs, ds, "fused dense", fused_train_step="on")
    check(f_dense["fused_step_launches"] == f_dense["steps"] and f_dense["bwd_launches"] == 0,
          "the fused dense run did not launch one fused step a step and no split backward")
    f_main = compacted_run(torch, fm, fk, fs, ds,
                           TrainConfig(n_iters=COMPACT_ITERS, fused_train_step="on"),
                           "fused shipped defaults")
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
    return dict(out, blocks=blocks, kw=kw)


# ---------------------------------------------------------------------------
# kernel #2 at the trained state, and the parent commit's times
# ---------------------------------------------------------------------------


def scratch_floor_ms(points: int, f: int, nh: int, ke: int = 0) -> float:
    """The scratch traffic floor of the backward over ``points`` points:
    every layer's bf16 activation and dz (and kernel #4's ``ke`` encoded
    features) written once and read back once, over the card's memory
    rate."""
    return 1e3 * 4 * ((nh + 1) * f * 2 + ke) * points / PEAK_BYTES_PER_S


def trained_row(torch, fm, packed, pbytes, x, g, label: str, enc=None) -> dict:
    """The MLP backward, kernel #2 (or with ``enc`` = (fe, a, w) the encoded
    kernel #4), on a gradient ``g`` a step really hands it at ``x``: the
    share of active 16-point tiles and points, the kernel against its plain
    version (check_bwd's limits, two launches bit-identical), dx exactly 0
    on every skipped tile, its time beside the bound and the scratch traffic
    floor over the active tiles (the work the kernel does: it skips the
    rest)."""
    ops = mlp_pair(fm, packed, enc)
    f, nh, n_in = packed.width, packed.n_hidden, ops["n_in"]
    grad_bytes = 4 * (n_in * f + nh * f * f + (nh + 1) * f + f + 1)
    p = x.shape[0]
    act = g != 0
    tiles = torch.nn.functional.pad(act, (0, (-p) % 16)).reshape(-1, 16).any(dim=1)
    skipped = ~tiles.repeat_interleave(16)[:p]
    n_tiles, n_act = tiles.numel(), int(tiles.sum())
    r = check_bwd(torch, fm, packed, p, None, pbytes, label, enc=enc, xg=(x, g))
    _, dx = ops["bwd"](x, g)
    dx_zero = bool((dx[skipped] == 0).all())
    pt = 16 * n_act
    b_ms, b_by = bound_ms(mlp_flops(pt, f, nh, n_in)[1],
                          p * 4 + pt * 12 + p * 12 + pbytes + grad_bytes)
    floor = scratch_floor_ms(pt, f, nh, packed.w_in.shape[1] if enc else 0)
    row = dict(P=p, tiles=n_tiles, active_tiles=n_act, active_tile_share=n_act / n_tiles,
               active_points=int(act.sum()), active_point_share=float(act.float().mean()),
               ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
               floor_ms=floor, max_abs_err=r["max_abs_err"],
               grad_norm_err=max(r["norm_errs"][:-1]), deterministic=r["deterministic"],
               dx_zero_on_skipped=dx_zero, dx_bad_share=r["dx_bad_share"],
               dx_rel_l2=r["dx_rel_l2"])
    print(f"{ops['name']}_bwd at {label}: P={p}, active tiles {n_act} of "
          f"{n_tiles} ({row['active_tile_share']:.4f}), active points "
          f"{row['active_points']} ({row['active_point_share']:.4f}); kernel_ms "
          f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f}; over the active tiles bound_ms "
          f"{b_ms:.4f} ({b_by}) and scratch traffic floor {floor:.4f} ms; dx exactly 0 on "
          f"the {int(skipped.sum())} points of skipped tiles {dx_zero}")
    check(dx_zero, f"{ops['name']}_bwd's dx is not 0 on the skipped tiles ({label})")
    return row


def trained_state_rows(torch, fm, packed, pbytes, raw_fn, blocks: dict, kw: dict,
                       enc=None) -> tuple[dict, dict]:
    """trained_row on the gradient the split composite hands the MLP
    backward at a trained state (``raw_fn``: the forward of that model), on
    each march block. Returns (the rows, the (x, g) of each block) under the
    blocks' names."""
    out, inputs = {}, {}
    for name, blk in blocks.items():
        x, g = split_raw_grad(torch, raw_fn, *blk, kw)
        out[name] = trained_row(torch, fm, packed, pbytes, x, g, f"the trained state, {name}",
                                enc=enc)
        inputs[name] = (x, g)
    return out, inputs


def bwd_trained_phase(torch, fm, state, fp: dict, report: dict) -> dict:
    """Kernel #2 at the 600-step run's trained state (trained_state_rows) at
    the four march shapes of the fused-step phase. Returns the rows and the
    (x, g) of each shape under its name for the parent's timing."""
    plist = fm.cppn_params_to_list(state.model)
    packed, pbytes = packed_of(torch, fm, state.model)
    out, inputs = trained_state_rows(torch, fm, packed, pbytes,
                                     lambda x: fm.fused_mlp_raw(plist, x), fp["blocks"], fp["kw"])
    report["bwd_trained"] = out
    return dict(rows=out, inputs=inputs, plist=plist)


# the parts of a launch by kernel name (the first name a kernel's holds):
# an MLP backward (kernel #2 or #4; the rest is the partial sums and, where
# the wrapper zeroes dx, that fill), and the whole-step kernel #6 (an
# earlier design's forward is mlp_chain.cuh's fwd_kernel, and the scan of
# either design is scan_kernel)
BWD_PARTS = (("chain", "bwd_chain_kernel"), ("wgrad", "wgrad_kernel"))
FS_PARTS = (("list", "tile_list_kernel"), ("fwd", "fwd_kernel"), ("scan", "scan_kernel"),
            ("chain", "bwd_chain_kernel"), ("wgrad", "wgrad_kernel"),
            ("reduce", "reduce_partials"))


def device_parts_ms(torch, launch, parts, n: int = 5) -> dict:
    """Device ms a call of ``launch`` in its ``parts`` (name, kernel name)
    and the rest, traced with torch.profiler over ``n`` calls; None where
    the profiler saw no device time (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in parts}
    out["rest"] = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        part = next((name for name, key in parts if key in ev.key), "rest")
        out[part] += dev_us / 1e3 / n
    return out if any(out.values()) else None


def parts_line(parts) -> str:
    return (" / ".join(f"{k} {v:.4f}" for k, v in parts.items()) if parts
            else "not measured")


def mean_parts(*runs):
    """The mean of a launch's profiled parts over the runs that measured
    them, None where none did."""
    have = [r for r in runs if r]
    return {q: sum(r[q] for r in have) / len(have) for q in have[0]} if have else None


def saved_times(root: str, path: str, ptxas: bool = False) -> dict:
    """Run this script with ``--time-saved`` against the package of the
    checkout ``root`` in a process of its own, on the inputs saved at
    ``path``: its kernel #1 (back to back and one launch at a time), kernel
    #2, #3, #4, #6 and split-pair times on them, the files of its kernel #1
    outputs at the dense shape and of its kernel #3, #4 and #6 outputs, its
    dense 60-step split and fourier runs, and with ``ptxas`` the ptxas
    tables of its four libraries (built first, in that process)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-saved", path,
                           "--root", os.path.abspath(root)] + (["--ptxas"] if ptxas else []),
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"the timing run of {root} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(lines[-1])
    print(f"checkout {root}: timed in {time.perf_counter() - t0:.1f} s")
    return out


def paired_times(torch, parent: str, saved: dict) -> tuple[dict, dict]:
    """The parent checkout's and this checkout's saved_times on the same
    inputs, each in fresh processes, in the order parent, this, this, parent
    (so a drift of the card or the host cancels): (parent, this), each with
    its two readings of every time under ``runs`` and their mean in place
    (also of kernels #2, #4 and #6's profiled parts), and the dense runs
    (split and fourier), kernel #1's, #3's, #4's and #6's outputs and (the
    parent's) ptxas tables of each side's first process."""
    path = os.path.join(HERE, "smoke_out", "parent_inputs.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(saved, path)
    runs = [saved_times(root, path, ptxas=i == 0)
            for i, root in enumerate((parent, HERE, HERE, parent))]
    sides = []
    for a, b in ((runs[0], runs[3]), (runs[1], runs[2])):
        side = dict(dense=a["dense"], dense_fourier=a["dense_fourier"], fwd_out=a["fwd_out"],
                    enc_out=a["enc_out"], enc_fwd_out=a["enc_fwd_out"], fs_out=a["fs_out"],
                    ptxas=a.get("ptxas"), lr=a["lr"],
                    shipped_runs=[r["shipped"] for r in (a, b)],
                    fourier_shipped_runs=[r["fourier_shipped"] for r in (a, b)])
        for key in ("bwd_ms", "enc_bwd_ms", "fs_ms", "split_pair_ms", "fwd_ms", "fwd_one_ms",
                    "enc_fwd_ms", "enc_fwd_one_ms"):
            side[key] = {k: (v + b[key][k]) / 2 for k, v in a[key].items()}
            side[key + "_runs"] = {k: [v, b[key][k]] for k, v in a[key].items()}
        for key in ("dense", "dense_fourier"):
            side[key + "_ms_runs"] = [r[key]["ms_per_step"] for r in (a, b)]
        for key in ("bwd_parts_ms", "enc_bwd_parts_ms", "fs_parts_ms"):
            side[key] = {k: mean_parts(v, b[key][k]) for k, v in a[key].items()}
        sides.append(side)
    return sides[0], sides[1]


# kernel #4's kernels in the encoded library (its chain and weight
# gradients; reduce_partials is shared with the dA slot sum)
ENC_BWD_KERNELS = ("bwd_chain_kernel", "wgrad_kernel")
# kernel #3 in a profile (the parent's mma.sync forward was fwd_kernel<F,
# EncX<KE>, false>)
ENC_FWD_KERNEL = "wgmma_enc_fwd_kernel"


def fwd_vs_parent(torch, par: dict, own: dict, kb: dict) -> dict:
    """Kernel #1 of this checkout against the parent's on the same input at
    the dense shape, with the random and the trained weights (each side's
    first fresh process): equal bit for bit, else the largest and the
    median |raw difference|, held to the forward limits; then the ptxas
    report: every kernel of the parent's four libraries but kernel #3's
    forward keeps its registers, stack frame and spills here, and #3's at F
    = 128, KE = 48 is shown beside the parent's."""
    mine_raw, theirs_raw = torch.load(own["fwd_out"]), torch.load(par["fwd_out"])
    out = {}
    for k, b in theirs_raw.items():
        a = mine_raw[k]
        d = (a - b).abs()
        scale = max(1.0, float(b.abs().max()))
        row = dict(equal=torch.equal(a, b), max_abs_diff=float(d.max()),
                   median_abs_diff=float(d.median()), output_scale=scale)
        print(f"fused_mlp_fwd against the parent commit's at P={TRAIN_P}, {k} weights: equal bit "
              f"for bit {row['equal']}, max |raw difference| {row['max_abs_diff']:.3e}, median "
              f"{row['median_abs_diff']:.3e} (output scale {scale:.3f})")
        check(row["max_abs_diff"] <= FWD_MAX_REL * scale
              and row["median_abs_diff"] <= FWD_MEDIAN_REL * scale,
              f"kernel #1 differs from the parent commit's beyond the forward limits ({k})")
        out[k] = row
    out["equal"] = all(r["equal"] for r in out.values())
    mine, theirs = kb["ptxas"], par["ptxas"]
    if not all(mine.values()):
        print("ptxas against the parent commit: not compared (this process loaded an earlier "
              "build, so it has no ptxas report)")
        return out
    compared, differ = 0, []
    for lib, table in theirs.items():
        for name, v in table.items():
            if lib == "fused_mlp_enc" and re.search(r"\dfwd_kernel", name):
                continue  # kernel #3's forward, redesigned
            compared += 1
            if tuple(mine[lib].get(name, ())) != tuple(v):
                differ.append(f"{lib} {name}: parent {v}, this {mine[lib].get(name)}")
    print(f"ptxas against the parent commit: {compared} kernels of the four libraries (all but "
          f"kernel #3's forward) compared on (registers, stack frame, spill stores, spill "
          f"loads): {len(differ)} differ" + ("".join(f"\n  {d}" for d in differ)))
    check(compared > 0 and not differ,
          "a kernel other than kernel #3's forward changed its ptxas registers or spills")
    out["ptxas_compared"] = compared
    # kernel #3 at F = 128, KE = 48: the parent's mma.sync forward beside the
    # wgmma one (whose spill build_kernels checks)
    old = [v for n, v in theirs["fused_mlp_enc"].items()
           if re.search(r"\dfwd_kernelILi128ENS_4EncXILi48E", n)]
    new = enc_fwd_ptxas(mine["fused_mlp_enc"])
    print(f"ptxas of kernel #3 at F=128, KE=48 (registers, stack frame, spill stores, spill "
          f"loads): this {new}, parent commit's {tuple(old[0]) if old else None}")
    out["enc_fwd_ptxas"] = dict(this=list(new) if new else None,
                                parent=list(old[0]) if old else None)
    return out


def enc_compare_inputs(torch, fm, rnd: dict, ep: dict) -> dict:
    """Kernel #4's inputs for the parent comparison: random_enc's fourier
    model and its BARF model at each of BARF_ALPHAS on the random (x, g) of
    ``rnd`` (fourier at each of its point counts, BARF at the first), and
    the fourier run's trained model on its trained-state (x, g). Returns
    models (packed as a tuple, a, w), inputs (x, g) and cases (model, input)
    by name, on the card."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe

    def model(packed, enc):
        return (tuple(packed), enc[1], enc[2])

    models = {"fourier": model(*random_enc(torch, fm, fe, "fourier")[::2])}
    models.update({f"barf alpha {a}": model(*random_enc(torch, fm, fe, "barf", a)[::2])
                   for a in BARF_ALPHAS})
    t_packed, _, t_enc = ep["trained_model"]
    models["trained fourier"] = model(t_packed, t_enc)
    inputs = {f"random: {k}": xg for k, xg in rnd.items()}
    inputs.update({f"trained: {k}": xg for k, xg in ep["trained_inputs"].items()})
    cases = {f"random: fourier, {k}": ("fourier", f"random: {k}") for k in rnd}
    first = next(iter(rnd))
    cases.update({f"random: barf alpha {a}, {first}": (f"barf alpha {a}", f"random: {first}")
                  for a in BARF_ALPHAS})
    cases.update({f"trained: fourier, {k}": ("trained fourier", f"trained: {k}")
                  for k in ep["trained_inputs"]})
    return dict(models=models, inputs=inputs, cases=cases)


def enc_launch(fm, fe, enc: dict, case: str):
    """A callable that runs kernel #4 on one case of enc_compare_inputs."""
    mk, ik = enc["cases"][case]
    packed, a, w = enc["models"][mk]
    packed = fm.PackedMLP(*packed)
    x, g = enc["inputs"][ik]
    return lambda: fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)


def canonical_outputs(torch, out) -> dict:
    """Kernel #4's outputs (grads, dA, dx) with every -0 made +0 (x + 0.0):
    the gradients and dA on the host, and the SHA-1 of dx's bytes."""
    grads, da, dx = out
    return dict(grads=[(t + 0.0).cpu() for pair in grads for t in pair], da=(da + 0.0).cpu(),
                dx_sha1=hashlib.sha1((dx + 0.0).cpu().numpy().tobytes()).hexdigest())


def enc_vs_parent(torch, par: dict, own: dict) -> dict:
    """Kernel #4 of this checkout against the parent's on every case of
    enc_compare_inputs (each side's first fresh process): its gradients,
    dA and dx equal bit for bit but for the sign of a zero."""
    mine, theirs = torch.load(own["enc_out"]), torch.load(par["enc_out"])
    out = {}
    for case, b in theirs.items():
        a = mine[case]
        grads = all(torch.equal(u, v) for u, v in zip(a["grads"], b["grads"]))
        da = torch.equal(a["da"], b["da"])
        dx = a["dx_sha1"] == b["dx_sha1"]
        worst = max(float((u - v).abs().max()) for u, v in zip(a["grads"], b["grads"]))
        out[case] = dict(grads=grads, da=da, dx=dx, max_abs_grad_diff=worst)
        print(f"fused_mlp_enc_bwd against the parent commit's, {case}: equal bit for bit but for "
              f"the sign of a zero: gradients {grads}, dA {da}, dx {dx} (largest gradient "
              f"difference {worst:.3e})")
    check(all(r["grads"] and r["da"] and r["dx"] for r in out.values()),
          "kernel #4's outputs differ from the parent commit's beyond the sign of a zero")
    return out


def enc_fwd_cases(ep: dict) -> dict:
    """Kernel #3's cases in the paired fresh processes, by name: (the model
    of enc_compare_inputs, P): the random fourier model at FWD1_PAIRED, the
    random BARF model at each of BARF_ALPHAS at TRAIN_P, the fourier run's
    trained model at its compacted point count."""
    cases = {f"fourier, P={p}": ("fourier", p) for p in FWD1_PAIRED}
    cases.update({f"barf alpha {a}, P={TRAIN_P}": (f"barf alpha {a}", TRAIN_P)
                  for a in BARF_ALPHAS})
    cases[f"trained fourier, P={ep['compact_p']}"] = ("trained fourier", ep["compact_p"])
    return cases


def hold_to_parent(same: bool, d: dict, pd: dict, lr_same: bool, run: str,
                   kernel: str) -> None:
    """A dense 60-step run (train loss and held-out PSNR ``d``) against the
    parent commit's (``pd``), where kernel ``kernel`` gives the parent's
    outputs bit for bit: equal bit for bit where both sides' Adam reads the
    same lr, else within LR_ULP_LOSS_REL and LR_ULP_PSNR_DB."""
    if lr_same:
        check(same, f"the {run} run differs from the parent commit's, though kernel {kernel} "
                    "gives the parent's outputs bit for bit and Adam reads the same lr")
        return
    loss_rel = abs(d["train_loss"] - pd["train_loss"]) / abs(pd["train_loss"])
    psnr_db = abs(d["heldout_psnr"] - pd["heldout_psnr"])
    print(f"{run} run against the parent commit's, lr schedules one f32 ulp apart: train loss "
          f"{loss_rel:.3e} relative (limit {LR_ULP_LOSS_REL:.0e}), held-out PSNR {psnr_db:.3e} "
          f"dB (limit {LR_ULP_PSNR_DB:.0e})")
    check(loss_rel <= LR_ULP_LOSS_REL and psnr_db <= LR_ULP_PSNR_DB,
          f"the {run} run differs from the parent commit's beyond the limits for lr schedules "
          f"one f32 ulp apart, though kernel {kernel} gives the parent's outputs bit for bit")


def enc_fwd_vs_parent(torch, par: dict, own: dict) -> dict:
    """Kernel #3 of this checkout against the parent's at every case of
    enc_fwd_cases (each side's first fresh process): equal bit for bit, else
    the largest and the median |raw difference|, held to the forward
    limits; where every case is equal, the dense 60-step fourier runs of
    the first two processes are held to each other (hold_to_parent)."""
    mine, theirs = torch.load(own["enc_fwd_out"]), torch.load(par["enc_fwd_out"])
    out = {}
    for case, b in theirs.items():
        a = mine[case]
        d = (a - b).abs()
        scale = max(1.0, float(b.abs().max()))
        row = dict(equal=torch.equal(a, b), max_abs_diff=float(d.max()),
                   median_abs_diff=float(d.median()), output_scale=scale)
        print(f"fused_mlp_enc_fwd against the parent commit's, {case}: equal bit for bit "
              f"{row['equal']}, max |raw difference| {row['max_abs_diff']:.3e}, median "
              f"{row['median_abs_diff']:.3e} (output scale {scale:.3f})")
        check(row["max_abs_diff"] <= FWD_MAX_REL * scale
              and row["median_abs_diff"] <= FWD_MEDIAN_REL * scale,
              f"kernel #3 differs from the parent commit's beyond the forward limits ({case})")
        out[case] = row
    equal = all(r["equal"] for r in out.values())
    d, pd = own["dense_fourier"], par["dense_fourier"]
    same = d["train_loss"] == pd["train_loss"] and d["heldout_psnr"] == pd["heldout_psnr"]
    mine_ms, theirs_ms = own["dense_fourier_ms_runs"], par["dense_fourier_ms_runs"]
    print(f"dense {DENSE_ITERS}-step fourier run (first two fresh processes): train loss "
          f"{d['train_loss']!r}, held-out PSNR {d['heldout_psnr']!r}; parent commit "
          f"{pd['train_loss']!r}, {pd['heldout_psnr']!r}; equal bit for bit {same}; steady "
          f"ms/step (host clock) in the fresh processes (parent, this, this, parent): this "
          f"{mine_ms[0]:.3f} / {mine_ms[1]:.3f}, parent commit {theirs_ms[0]:.3f} / "
          f"{theirs_ms[1]:.3f} (this / parent {sum(mine_ms) / sum(theirs_ms):.3f})")
    if equal:
        hold_to_parent(same, d, pd, own["lr"] == par["lr"], "dense fourier", "#3")
    return dict(cases=out, equal=equal, dense_fourier_equal=same,
                dense_fourier_ms_per_step=dict(this=mine_ms, parent=theirs_ms))


def fs_vs_parent(torch, par: dict, own: dict) -> dict:
    """Kernel #6 of this checkout against the parent's at the four march
    shapes with the random and the trained weights (each side's first fresh
    process): pixels equal bit for bit, gradients equal bit for bit but for
    the sign of a zero."""
    mine, theirs = torch.load(own["fs_out"]), torch.load(par["fs_out"])
    out = {}
    for case, b in theirs.items():
        a = mine[case]
        px = torch.equal(a["pixels"], b["pixels"])
        grads = all(torch.equal(u, v) for u, v in zip(a["grads"], b["grads"]))
        worst = max(float((u - v).abs().max()) for u, v in zip(a["grads"], b["grads"]))
        out[case] = dict(pixels=px, grads=grads, max_abs_grad_diff=worst)
        print(f"fused_step against the parent commit's, {case}: pixels equal bit for bit {px}; "
              f"gradients equal bit for bit but for the sign of a zero {grads} (largest "
              f"difference {worst:.3e})")
    check(len(out) == 8 and all(r["pixels"] and r["grads"] for r in out.values()),
          "kernel #6's pixels or gradients differ from the parent commit's")
    return out


def bwd_compare_phase(torch, fm, tr: dict, fp: dict, bt: dict, ep: dict, parent: str | None,
                      report: dict, kb: dict) -> dict:
    """Kernel #2 at random g (all tiles active) beside the scratch traffic
    floor, and kernel #4 on enc_compare_inputs; with ``parent`` (a checkout
    of the parent commit), kernels #2 and #4 on the same random and
    trained-state inputs and the split pairs on the same march blocks, of
    the parent and of this checkout alike in fresh processes (paired_times)
    with kernel #1 beside them (fwd_vs_parent), #4's outputs against the
    parent's (enc_vs_parent), kernel #6 on the march blocks with both weight
    sets, its outputs against the parent's (fs_vs_parent), kernel #3 and
    its outputs against the parent's (enc_fwd_vs_parent), and the parent's
    dense 60-step run, whose train loss and held-out PSNR this tree's must
    equal bit for bit where kernel #1 gives the parent's outputs bit for bit
    (kernel #2's skipped tiles add exact zeros) and both sides' Adam reads
    the same lr (lr_schedule), else come within LR_ULP_LOSS_REL and
    LR_ULP_PSNR_DB (hold_to_parent), with both sides' steady ms/step; and the
    shipped and fourier 600-step runs' steady rays/s of both sides."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe

    model, gen = random_cppn(torch)
    packed, _ = packed_of(torch, fm, model)
    f, nh = packed.width, packed.n_hidden
    gen.manual_seed(6)
    rnd = {}
    for p in BWD_RANDOM_P:
        rnd[f"P={p}"] = ((torch.rand((p, 3), generator=gen) * 2.0 - 1.0).to(DEVICE),
                         (torch.randn((p,), generator=gen) / p).to(DEVICE))
    ms = {f"random: {k}": time_ms(torch, lambda x=x, g=g: fm.fused_mlp_bwd_cuda(packed, x, g))
          for k, (x, g) in rnd.items()}
    ms.update({f"trained: {k}": r["ms"] for k, r in bt["rows"].items()})
    split = {k: v["random"]["split_pair_ms"] for k, v in fp["shapes"].items()}
    floors = {f"random: {k}": scratch_floor_ms(x.shape[0], f, nh) for k, (x, _) in rnd.items()}
    floors.update({f"trained: {k}": r["floor_ms"] for k, r in bt["rows"].items()})
    enc = enc_compare_inputs(torch, fm, rnd, ep)
    enc_ms = {case: time_ms(torch, enc_launch(fm, fe, enc, case)) for case in enc["cases"]}
    out = dict(ms=ms, split_pair_ms=split, floor_ms=floors, enc_ms=enc_ms,
               dense=dict(train_loss=tr["train_loss"], heldout_psnr=tr["heldout_psnr"]))
    par = own = None
    if parent:
        def cpu(plist):
            return [(w.detach().cpu(), b.detach().cpu()) for w, b in plist]

        par, own = paired_times(torch, parent, dict(
            trained={k: (x.cpu(), g.cpu()) for k, (x, g) in bt["inputs"].items()},
            random={k: (x.cpu(), g.cpu()) for k, (x, g) in rnd.items()},
            trained_plist=cpu(bt["plist"]), random_plist=cpu(fm.cppn_params_to_list(model)),
            blocks={k: tuple(t.cpu() for t in blk) for k, blk in fp["blocks"].items()},
            kw=fp["kw"],
            enc=dict(models={k: (tuple(t.cpu() for t in pk), a.cpu(), w.cpu())
                             for k, (pk, a, w) in enc["models"].items()},
                     inputs={k: (x.cpu(), g.cpu()) for k, (x, g) in enc["inputs"].items()},
                     cases=enc["cases"]),
            enc_fwd=enc_fwd_cases(ep)))
        out.update(parent=par, paired=own)
        out["fwd_vs_parent"] = fwd_vs_parent(torch, par, own, kb)
        out["enc_vs_parent"] = enc_vs_parent(torch, par, own)
        out["fs_vs_parent"] = fs_vs_parent(torch, par, own)
        out["enc_fwd_vs_parent"] = enc_fwd_vs_parent(torch, par, own)

    def vs_parent(key: str, k: str) -> str:
        if not par:
            return ""
        a, b = own[key + "_runs"][k], par[key + "_runs"][k]
        return (f"; fresh processes (parent, this, this, parent): this {a[0]:.4f} / {a[1]:.4f} "
                f"ms, parent commit {b[0]:.4f} / {b[1]:.4f} ms (this / parent "
                f"{own[key][k] / par[key][k]:.3f})")

    def parts(key: str, k: str) -> str:
        if not par:
            return ""
        a, b = own[key][k], par[key][k]
        return ("; device ms a launch, chain / weight gradients / rest (profiled, fresh): this "
                + (" / ".join(f"{t:.4f}" for t in a.values()) if a else "not measured")
                + ", parent commit "
                + (" / ".join(f"{t:.4f}" for t in b.values()) if b else "not measured"))

    for k, v in ms.items():
        print(f"fused_mlp_bwd {k}: kernel_ms {v:.4f}, scratch traffic floor {floors[k]:.4f} ms"
              + vs_parent("bwd_ms", k) + parts("bwd_parts_ms", k))
    for k, v in enc_ms.items():
        print(f"fused_mlp_enc_bwd {k}: kernel_ms {v:.4f}" + vs_parent("enc_bwd_ms", k)
              + parts("enc_bwd_parts_ms", k))
    for k in (own or {}).get("fs_ms", {}):
        print(f"fused_step {k}" + vs_parent("fs_ms", k)
              + f"; device ms a launch by part (profiled, fresh): this "
              + parts_line(own["fs_parts_ms"][k]) + ", parent commit "
              + parts_line(par["fs_parts_ms"][k]))
    for k, v in split.items():
        print(f"split pair {k}: {v:.4f} ms" + vs_parent("split_pair_ms", k))
    for k in (own or {}).get("fwd_ms", {}):
        print(f"fused_mlp_fwd {k}, random weights, back to back" + vs_parent("fwd_ms", k))
        print(f"fused_mlp_fwd {k}, random weights, one launch" + vs_parent("fwd_one_ms", k))
    for k in (own or {}).get("enc_fwd_ms", {}):
        print(f"fused_mlp_enc_fwd {k}, back to back" + vs_parent("enc_fwd_ms", k))
        print(f"fused_mlp_enc_fwd {k}, one launch" + vs_parent("enc_fwd_one_ms", k))
    d = out["dense"]
    same = bool(par) and (d["train_loss"] == par["dense"]["train_loss"]
                          and d["heldout_psnr"] == par["dense"]["heldout_psnr"])
    # the runs can be equal only where both packages' Adam reads the same lr
    lr_same = bool(par) and own["lr"] == par["lr"]
    if par:
        diff = [i for i, (a, b) in enumerate(zip(own["lr"], par["lr"])) if a != b]
        print(f"lr schedule against the parent commit's at steps 0..{DENSE_ITERS}: "
              + ("equal bit for bit (f32)" if lr_same else
                 f"differs at {len(diff)} steps (first at step {diff[0]}: this "
                 f"{own['lr'][diff[0]]!r}, parent {par['lr'][diff[0]]!r}); the runs are "
                 "held within LR_ULP_LOSS_REL and LR_ULP_PSNR_DB"))
        for key, label in (("shipped", "shipped-default"), ("fourier_shipped", "fourier")):
            a_runs, b_runs = own[key + "_runs"], par[key + "_runs"]
            a_rs = [r["steady_rays_per_sec"] for r in a_runs]
            b_rs = [r["steady_rays_per_sec"] for r in b_runs]
            print(f"{label} run, steady rays/s in the fresh processes (parent, this, this, "
                  f"parent): this {a_rs[0]:.0f} / {a_rs[1]:.0f}, parent commit {b_rs[0]:.0f} / "
                  f"{b_rs[1]:.0f} (this / parent {sum(a_rs) / sum(b_rs):.3f}); end to end this "
                  + " / ".join(f"{r['rays_per_sec']:.0f}" for r in a_runs) + ", parent "
                  + " / ".join(f"{r['rays_per_sec']:.0f}" for r in b_runs)
                  + "; best held-out PSNR this "
                  + " / ".join(f"{r['best_heldout_psnr']:.3f}" for r in a_runs) + ", parent "
                  + " / ".join(f"{r['best_heldout_psnr']:.3f}" for r in b_runs)
                  + f"; graphs this {[r['graphs'] for r in a_runs]}")
    print(f"dense {DENSE_ITERS}-step split run: train loss {d['train_loss']!r}, held-out PSNR "
          f"{d['heldout_psnr']!r}"
          + (f"; parent commit {par['dense']['train_loss']!r}, {par['dense']['heldout_psnr']!r}; "
             f"equal bit for bit {same}; steady ms/step (host clock) in the fresh processes "
             f"(parent, this, this, parent): this " + " / ".join(
                 f"{v:.3f}" for v in own["dense_ms_runs"]) + ", parent commit " + " / ".join(
                 f"{v:.3f}" for v in par["dense_ms_runs"]) if par else ""))
    out["dense_equal_parent"] = same if par else None
    out["lr_equal_parent"] = lr_same if par else None
    if par and out["fwd_vs_parent"]["equal"]:
        hold_to_parent(same, d, par["dense"], lr_same, "dense split", "#1")
    report["bwd_compare"] = out
    return out


def time_saved(torch, fm, path: str, mods=None) -> dict:
    """The ``--time-saved`` run: with ``mods`` (the other three kernel
    modules) first every library built at once and its ptxas table; kernel
    #1 at FWD1_PAIRED on seeded inputs with the saved random weights, and
    its outputs at the dense shape with the random and the trained weights
    (saved to a file beside ``path``); kernel #2 (and its profiled parts) and
    the split pair of this process's package on the saved inputs (CUDA-event
    medians), kernel #4 (and its profiled parts) on the saved encoded cases
    (enc_compare_inputs) with its outputs (canonical_outputs) saved to a
    file beside ``path``, kernel #3 on the saved encoded models at the saved
    point counts (back to back and one launch) with its outputs saved to a
    file beside ``path``, kernel #6 (and its profiled parts) on the saved
    march blocks with the random and the trained weights, its pixels and
    gradients (-0 made +0) saved to a file beside ``path``, and, with
    the dense 60-step split and fourier runs' train loss and held-out PSNR
    (full precision) and steady ms/step."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
    from nerf_for_angiography_tpu_torch.training import TrainConfig, train

    out = {"bwd_ms": {}, "bwd_parts_ms": {}, "enc_bwd_ms": {}, "enc_bwd_parts_ms": {},
           "fs_ms": {}, "fs_parts_ms": {}, "split_pair_ms": {}, "fwd_ms": {}, "fwd_one_ms": {},
           "enc_fwd_ms": {}, "enc_fwd_one_ms": {}}
    if mods:
        libs = (fm, *mods)
        with ThreadPoolExecutor(len(libs)) as ex:
            list(ex.map(lambda mod: mod._load_lib(), libs))
        out["ptxas"] = {mod.__name__.rsplit(".", 1)[-1]: ptxas_table(mod.build_log)
                        for mod in libs}
    saved = torch.load(path)
    dev = torch.device(DEVICE)

    def to_dev(v):  # parameters, as the split pair differentiates them
        return [tuple(t.to(dev).requires_grad_(True) for t in pair) for pair in v]

    packed = fm.pack_params(to_dev(saved["random_plist"]))
    for p in FWD1_PAIRED:
        x = (torch.rand((p, 3), generator=torch.Generator().manual_seed(p)) * 2.0 - 1.0).to(dev)
        out["fwd_ms"][f"P={p}"] = time_ms_b2b(torch, lambda: fm.fused_mlp_fwd_cuda(packed, x))
        out["fwd_one_ms"][f"P={p}"] = time_ms(torch, lambda: fm.fused_mlp_fwd_cuda(packed, x))
    x = (torch.rand((TRAIN_P, 3), generator=torch.Generator().manual_seed(7)) * 2.0 - 1.0).to(dev)
    raws = {k: fm.fused_mlp_fwd_cuda(fm.pack_params(to_dev(saved[k + "_plist"])), x).cpu()
            for k in ("random", "trained")}
    out["fwd_out"] = f"{path}.fwd.{os.getpid()}.pt"
    torch.save(raws, out["fwd_out"])
    for key, plist_key in (("trained", "trained_plist"), ("random", "random_plist")):
        packed = fm.pack_params(to_dev(saved[plist_key]))
        for name, (x, g) in saved[key].items():
            x, g = x.to(dev), g.to(dev)
            out["bwd_ms"][f"{key}: {name}"] = time_ms(
                torch, lambda: fm.fused_mlp_bwd_cuda(packed, x, g))
            out["bwd_parts_ms"][f"{key}: {name}"] = device_parts_ms(
                torch, lambda: fm.fused_mlp_bwd_cuda(packed, x, g), BWD_PARTS)
    enc = dict(saved["enc"], models={
        k: (tuple(t.to(dev) for t in pk), a.to(dev), w.to(dev))
        for k, (pk, a, w) in saved["enc"]["models"].items()},
        inputs={k: (x.to(dev), g.to(dev)) for k, (x, g) in saved["enc"]["inputs"].items()})
    enc_out = {}
    for case in enc["cases"]:
        launch = enc_launch(fm, fe, enc, case)
        out["enc_bwd_ms"][case] = time_ms(torch, launch)
        out["enc_bwd_parts_ms"][case] = device_parts_ms(torch, launch, BWD_PARTS)
        enc_out[case] = canonical_outputs(torch, launch())
    out["enc_out"] = f"{path}.enc.{os.getpid()}.pt"
    torch.save(enc_out, out["enc_out"])
    # kernel #3 on the saved encoded models at the saved point counts (x
    # seeded by P), back to back and one launch, and its outputs
    enc_fwd_out = {}
    for case, (mk, p) in saved["enc_fwd"].items():
        packed, a, w = enc["models"][mk]
        x = (torch.rand((p, 3), generator=torch.Generator().manual_seed(p)) * 2.0 - 1.0).to(dev)

        def launch(packed=fm.PackedMLP(*packed), a=a, w=w, x=x):
            return fe.fused_mlp_enc_fwd_cuda(packed, a, w, x)

        out["enc_fwd_ms"][case] = time_ms_b2b(torch, launch)
        out["enc_fwd_one_ms"][case] = time_ms(torch, launch)
        enc_fwd_out[case] = launch().cpu()
    out["enc_fwd_out"] = f"{path}.encfwd.{os.getpid()}.pt"
    torch.save(enc_fwd_out, out["enc_fwd_out"])
    blocks = {name: tuple(t.to(dev) for t in blk) for name, blk in saved["blocks"].items()}
    fs_out = {}
    for weights in ("random", "trained"):
        packed = fm.pack_params(to_dev(saved[weights + "_plist"]))
        for name, blk in blocks.items():
            case = f"{name}, {weights} weights"

            def launch(blk=blk, packed=packed):
                return fs.fused_step_grads_cuda(packed, *blk, **saved["kw"])

            out["fs_ms"][case] = time_ms(torch, launch)
            out["fs_parts_ms"][case] = device_parts_ms(torch, launch, FS_PARTS)
            px, grads = launch()
            fs_out[case] = dict(pixels=px.cpu(),
                                grads=[(t + 0.0).cpu() for pair in grads for t in pair])
    out["fs_out"] = f"{path}.fs.{os.getpid()}.pt"
    torch.save(fs_out, out["fs_out"])
    plist = to_dev(saved["random_plist"])
    for name, blk in blocks.items():
        out["split_pair_ms"][name] = time_ms(
            torch, lambda: split_pair(torch, fm, plist, *blk, saved["kw"]), reps=5, warmup=2)
    ds = make_dataset(torch)
    cfg = TrainConfig(compact_samples=0, n_iters=DENSE_ITERS, display_every=30)
    # the split run, and the same run of a fourier model (kernels #3 and #4
    # on every step): the fourier run's steady ms/step is the end-to-end time
    # #3 moves, the split run's a control that #3 never runs
    for key, c in (("dense", cfg), ("dense_fourier", dataclasses.replace(cfg, pos_enc="fourier"))):
        res = train(c, ds.rays, src_pt_z=SRC_Z, verbose=False, device=DEVICE)
        out[key] = dict(train_loss=train_loss(torch, res.state, ds.rays, c)[0],
                        heldout_psnr=res.last_psnr, best_heldout_psnr=res.best_heldout_psnr,
                        ms_per_step=1e3 * res.timing["step_dense"] / c.n_iters)
    out["lr"] = lr_schedule(torch, cfg, DENSE_ITERS + 1)
    # the shipped run and its fourier twin end to end (the loop's steady
    # rays/s: compacted steps outside first steps and captures)
    for key, c in (("shipped", TrainConfig(n_iters=COMPACT_ITERS)),
                   ("fourier_shipped", TrainConfig(pos_enc="fourier", n_iters=ENC_FOURIER_ITERS,
                                                   display_every=100))):
        with recorded_chunks() as chunks:
            res = train(c, ds.rays, src_pt_z=SRC_Z, verbose=False, device=DEVICE)
        t = res.timing
        out[key] = dict(steady_rays_per_sec=t["steady_rays_per_sec"],
                        rays_per_sec=res.rays_per_sec, total_s=t["total"],
                        compile_s=t["compile"], step_compact_s=t["step_compact"],
                        step_dense_s=t["step_dense"], best_heldout_psnr=res.best_heldout_psnr,
                        graphs=sum(c.captures for c in chunks))
    return out


def lr_schedule(torch, cfg, n: int) -> list[float]:
    """The f32 lr the package's Adam reads at steps 0..n-1: from its
    schedule on the device (ExponentialDecayLR.value), or from a host
    LambdaLR stepped along (a parent checkout's)."""
    from nerf_for_angiography_tpu_torch.training import make_optimizer

    opt, sched = make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1, device=DEVICE))])
    if hasattr(sched, "value"):
        return [float(sched.value(torch.tensor(s, device=DEVICE))) for s in range(n)]
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the scheduler stepped without optimizer steps
        for _ in range(n):
            out.append(float(torch.tensor(opt.param_groups[0]["lr"], dtype=torch.float32)))
            sched.step()
    return out


# ---------------------------------------------------------------------------
# the encoded pair (kernels #3/#4): fourier and BARF
# ---------------------------------------------------------------------------

BARF_ALPHAS = (0.0, 2.7, 5.0)
ENC_BASIS = 5


def random_enc(torch, fm, fe, kind: str, alpha: float = 0.0):
    """The encoded pair's inputs at full width: random_cppn's 4x128 chain with
    an L = 5 encoding (the fourier coefficients drawn by the module, ~ N(0,
    5^2); the BARF window at ``alpha``), packed, with (a, w) and the
    generator that drew them."""
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig

    gen = torch.Generator().manual_seed(0)
    model = CPPN(CPPNConfig(num_early_layers=4, num_filters=128, pos_enc=kind,
                            pos_enc_basis=ENC_BASIS), generator=gen)
    with torch.no_grad():
        for lin in model.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    model = model.to(DEVICE)
    return (*packed_enc_of(torch, fm, fe, model, alpha), gen)


def packed_enc_of(torch, fm, fe, model, alpha: float = 0.0):
    """(packed, parameter bytes, (fe, a, w)) of an encoded model, the BARF
    window at ``alpha``."""
    from nerf_for_angiography_tpu_torch.models import barf_k_values, barf_weights

    c = model.config
    packed = fe.pack_enc_params(fm.cppn_params_to_list(model), c.pos_enc_basis)
    if c.pos_enc == "fourier":
        enc = model.fourier_coefficients_pts.detach()
    else:
        enc = barf_weights(alpha, barf_k_values(c.pos_enc_basis, 3)).to(DEVICE)
    a, w = fe.enc_arrays(c.pos_enc, c.pos_enc_basis, enc)
    pbytes = sum(t.numel() * t.element_size() for t in packed) + 8 * a.numel()
    return packed, pbytes, (fe, a.contiguous(), w.contiguous())


def encoded_phase(torch, fm, fk, fs, fe, ds, report: dict) -> dict:
    """Phase 6: kernels #3/#4 against their plain versions (fourier at the
    path's forward shapes and the training backward; BARF at each of
    BARF_ALPHAS), the fourier and BARF training runs, the backward at the
    fourier run's compacted point count and at its trained state (on the
    split composite's gradient: trained_state_rows), the fourier compacted
    step profile."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import TrainConfig
    from nerf_for_angiography_tpu_torch.training.train import _flat_positions, _march_for

    labels = dict(zip(FWD_SHAPES, ("train", "grid warmup", "grid slab", "eval")))
    packed, pbytes, enc, gen = random_enc(torch, fm, fe, "fourier")
    checks = dict(
        fourier_fwd=[check_fwd(torch, fm, packed, p, gen, pbytes, f"fourier, {labels[p]}", enc)
                     for p in FWD_SHAPES],
        fourier_bwd=check_bwd(torch, fm, packed, TRAIN_P, gen, pbytes, "fourier, train", enc),
    )
    for alpha in BARF_ALPHAS:
        b_packed, b_pbytes, b_enc, b_gen = random_enc(torch, fm, fe, "barf", alpha)
        lab = f"barf alpha {alpha}, train"
        checks[f"barf_{alpha}"] = dict(
            fwd=check_fwd(torch, fm, b_packed, TRAIN_P, b_gen, b_pbytes, lab, b_enc),
            bwd=check_bwd(torch, fm, b_packed, TRAIN_P, b_gen, b_pbytes, lab, b_enc))

    fcfg = TrainConfig(pos_enc="fourier", n_iters=ENC_FOURIER_ITERS, display_every=100)
    fourier = compacted_run(torch, fm, fk, fs, ds, fcfg, "fourier_shipped")
    check(fourier["compact_steps"] > 0, "the fourier run never engaged the compacted stepper")
    bcfg = TrainConfig(pos_enc="barf", barf_start=0, barf_stop=ENC_BARF_ITERS,
                       n_iters=ENC_BARF_ITERS, display_every=100)
    barf = compacted_run(torch, fm, fk, fs, ds, bcfg, "barf_anneal")
    check(barf["barf_coarse_first"] == 0.0 and barf["barf_coarse_last"] == float(ENC_BASIS),
          "the BARF run's alpha did not rise from 0 to L")

    # the backward at the point count of the fourier run's final Tuning,
    # and the forward there with its trained weights
    state = fourier["result"].state
    batch = sample_pixel_rays(state.generator, ds.rays, fcfg.img_sample_size, impl="gumbel")
    # (the Tuning it ended on, else its last compacted phase's)
    final = fourier["tuning_final"] or {k: fourier["phases"][-1][k]
                                        for k in ("mode", "k", "w_cap", "w_lo", "k_lo")}
    tcfg = tuning_cfg(fcfg, final)
    near, far = SRC_Z - fcfg.outside, SRC_Z + fcfg.outside
    p = _flat_positions(_march_for(tcfg, state.grid, batch.origins, batch.directions,
                                   near, far)).shape[0]
    checks["compact_bwd"] = check_bwd(torch, fm, packed, p, gen, pbytes,
                                      f"fourier, compacted step {final}", enc)
    t_packed, t_pbytes, t_enc = packed_enc_of(torch, fm, fe, state.model)
    checks["compact_fwd_trained"] = check_fwd(torch, fm, t_packed, p, gen, t_pbytes,
                                              f"fourier, compacted step {final}, trained", t_enc)
    # kernel #4 on the gradient the split composite hands it at the trained
    # state: the final Tuning's marches and any two-bucket Tuning the run
    # reached
    plist = fm.cppn_params_to_list(state.model)
    enc_params = {"coeff": state.model.fourier_coefficients_pts}
    kw = dict(step=(2 * fcfg.outside) / fcfg.depth_samples_per_ray,
              early_stop_eps=fcfg.early_stop_eps, n_rays_loss=fcfg.img_sample_size,
              input_scale=state.model.config.input_scale)
    keys = ("mode", "k", "w_cap", "w_lo", "k_lo")
    tunings = [final] + [t for t in fourier["phases"] if t["w_lo"] > 0]
    tunings = [t for i, t in enumerate(tunings)
               if all(any(t[q] != u[q] for q in keys) for u in tunings[:i])]
    blocks = {}
    for t in tunings:
        name = f"{t['mode']} k={t['k']}" + (
            f" w_cap={t['w_cap']} w_lo={t['w_lo']} k_lo={t['k_lo']}" if t["w_lo"] else "")
        bl = rect_blocks(_march_for(tuning_cfg(fcfg, t), state.grid, batch.origins,
                                    batch.directions, near, far),
                         batch.origins, batch.directions, batch.pixel_values)
        blocks.update({name: bl[0]} if len(bl) == 1 else {f"{name} lo": bl[0], f"{name} hi": bl[1]})
    t_rows, t_inputs = trained_state_rows(
        torch, fm, t_packed, t_pbytes,
        lambda x: fe.fused_mlp_enc_raw(("fourier", ENC_BASIS), plist, enc_params, x),
        blocks, kw, enc=t_enc)
    check(all(r["active_tile_share"] < 1 for r in t_rows.values()),
          "kernel #4 found every tile active at the fourier run's trained state")
    for r in [*checks["fourier_fwd"], checks["compact_fwd_trained"],
              *(v["fwd"] for k, v in checks.items() if k.startswith("barf_"))]:
        r.pop("x", None)

    print(f"fourier compacted step profile at the final Tuning {final}:")
    prof = step_profile(torch, state, ds.rays, tcfg)
    check(prof["host_waits_per_step"] == 0,
          f"the fourier compacted step waits for the device {prof['host_waits_per_step']} times")
    print(f"  fourier compacted: {profile_row(prof)}")
    prof["enc_bwd_kernels_ms"] = {k: sum(r["ms_per_step"] for r in prof["top"] if k in r["name"])
                                  for k in ENC_BWD_KERNELS}
    enc_ms = sum(prof["enc_bwd_kernels_ms"].values())
    print("  kernel #4 in the fourier step: " + (
        f"chain {prof['enc_bwd_kernels_ms']['bwd_chain_kernel']:.4f} + weight gradients "
        f"{prof['enc_bwd_kernels_ms']['wgrad_kernel']:.4f} ms/step, "
        f"{enc_ms / prof['device_ms_per_step']:.3f} of the step's device time"
        if prof["device_ms_per_step"] else "not measured (no device time in the profile)"))
    prof["enc_fwd_kernel_ms"] = sum(r["ms_per_step"] for r in prof["top"]
                                    if ENC_FWD_KERNEL in r["name"])
    print("  kernel #3 in the fourier step: " + (
        f"{ENC_FWD_KERNEL} {prof['enc_fwd_kernel_ms']:.4f} ms/step, "
        f"{prof['enc_fwd_kernel_ms'] / prof['device_ms_per_step']:.3f} of the step's device time"
        if prof["device_ms_per_step"] else "not measured (no device time in the profile)"))
    states = {"fourier": fourier.pop("result").state, "barf": barf.pop("result").state}
    out = dict(checks=checks, fourier_shipped=fourier, barf_anneal=barf, compact_p=p,
               final=final, profile=prof, trained=t_rows)
    report["encoded"] = out
    src = "nerf_for_angiography_tpu_torch/csrc/"
    rows = []
    for name, r, line, file in (("fused_mlp_enc_fwd", checks["fourier_fwd"][0], 539,
                                 "mlp_wgmma.cuh"),
                                ("fused_mlp_enc_bwd", checks["fourier_bwd"], 551,
                                 "fused_mlp_enc.cu")):
        rows.append(dict(
            name=name, route="cuda", source=src + file,
            replaces=f"nerf_for_angiography_tpu/ops/pallas/fused_mlp.py:{line}",
            launches=0, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        ))
    rows[0]["ms_back_to_back"] = checks["fourier_fwd"][0]["ms_back_to_back"]
    rows[0]["shapes"] = {r["label"]: {k: r[k] for k in ("P", "ms", "ms_back_to_back", "plain_ms",
                                                       "bound_ms", "max_abs_err",
                                                       "median_abs_err")}
                         for r in [*checks["fourier_fwd"], checks["compact_fwd_trained"],
                                   *(v["fwd"] for k, v in checks.items()
                                     if k.startswith("barf_"))]}
    rows[0]["fourier_step_profile_ms"] = prof["enc_fwd_kernel_ms"]
    rows[1]["compact_path"] = {k: checks["compact_bwd"][k]
                               for k in ("P", "ms", "plain_ms", "bound_ms", "bound_by")}
    return dict(out, rows=rows, trained_inputs=t_inputs,
                trained_model=(t_packed, t_pbytes, t_enc), states=states)


# the graph phase's replayed-against-eager window: from step 208, 144 steps
# meet dense grid updates at 208, 224 and 240, the end of the dense warm-up
# at 256, then slabs 0, 1, 2, 3, 0 and 1 (every 16 steps): each kind's first
# step is an eager warm-up, its later steps (dense, slabs 0 and 1, and every
# step without an update) replays
GRAPH_START, GRAPH_STEPS = 208, 144


def state_tensors_of(state) -> dict:
    """Every tensor a step writes: parameters, both Adam moments and its
    step, the lr, both grids, the generator's state and the step counter;
    with pose refinement also the view shifts' AdamW group (its state and
    lr)."""
    out = {f"param/{n}": p for n, p in state.model.named_parameters()}
    opt = state.optimizer
    for i, p in enumerate(opt.param_groups[0]["params"]):
        out.update({f"adam/{i}/{k}": v for k, v in opt.state[p].items()})
    out["lr"] = opt.param_groups[0]["lr"]
    for j, group in enumerate(opt.param_groups[1:], 1):
        for i, p in enumerate(group["params"]):
            out.update({f"group{j}/{i}/{k}": v for k, v in opt.state[p].items()})
        out[f"group{j}/lr"] = group["lr"]
    for name in ("grid", "vessel_grid"):
        out.update({f"{name}/{k}": v for k, v in getattr(state, name)._asdict().items()
                    if v is not None})
    out["generator"] = state.generator.get_state()
    out["step_dev"] = state.step_dev
    return out


def graph_phase(torch, fm, fk, fs, ds, cp: dict, ep: dict, report: dict) -> dict:
    """Phase 7: the chunked step (make_train_chunk), each step one replay of
    a captured CUDA graph, against the eager step for each step kind (dense,
    lattice k=160, the fixed two-bucket Tuning, the fused step at the
    lattice, fourier at the lattice, and BARF across a rising alpha), from
    copies of one trained state set to GRAPH_START: GRAPH_STEPS steps each
    way, the parameters, Adam state, lr, grids, generator, metrics and
    pixels bit for bit, every launch count the same, and each way's peak
    device memory; then 16 replayed steps profiled beside 16 eager steps
    of copies of the trained state (host issue ms/step, device ms/step,
    busy share)."""
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, copy_state, make_train_chunk, make_train_step,
    )

    rays = ds.rays._replace(sampling_table=build_sampling_table(ds.rays.weights))
    base = TrainConfig()
    shipped = cp["shipped"]["result"].state
    kinds = {
        "dense": (shipped, dataclasses.replace(base, compact_samples=0)),
        "lattice k=160": (shipped, tuning_cfg(base, LATTICE)),
        "two-bucket": (shipped, tuning_cfg(base, TWO_BUCKET)),
        "fused lattice k=160": (shipped, dataclasses.replace(tuning_cfg(base, LATTICE),
                                                               fused_train_step="on")),
        "fourier lattice k=160": (ep["states"]["fourier"],
                                  tuning_cfg(TrainConfig(pos_enc="fourier"), LATTICE)),
        "barf lattice k=160, rising alpha": (
            ep["states"]["barf"],
            tuning_cfg(TrainConfig(pos_enc="barf", barf_start=0, barf_stop=400), LATTICE)),
    }
    near, far = SRC_Z - base.outside, SRC_Z + base.outside
    out = {}
    for name, (src, cfg) in kinds.items():
        print(f"--- graph phase, {name}: {GRAPH_STEPS} replayed against {GRAPH_STEPS} eager "
              f"steps from step {GRAPH_START}")
        runs = {}
        for way in ("graph", "eager"):
            st = copy_state(src)
            st.step = GRAPH_START
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_all(fm, fk, fs)
            t0 = time.perf_counter()
            if way == "graph":
                chunk = make_train_chunk(st.model, cfg, near, far, GRAPH_STEPS)
                _, metrics, pix, tgt = chunk(st, rays)
            else:
                step = make_train_step(st.model, cfg, near, far)
                for _ in range(GRAPH_STEPS):
                    _, metrics, pix, tgt = step(st, rays)
            torch.cuda.synchronize()
            runs[way] = dict(state=st, metrics=metrics, pix=pix, tgt=tgt,
                             counts=read_counts(fm, fk, fs), wall_s=time.perf_counter() - t0,
                             peak_gib=(torch.cuda.max_memory_allocated() - mem0) / 2**30)
        g, e = runs["graph"], runs["eager"]
        got, want = state_tensors_of(g["state"]), state_tensors_of(e["state"])
        unequal = [k for k in want if not torch.equal(got[k], want[k])]
        unequal += [f"metric {k}" for k in e["metrics"]
                    if not torch.equal(g["metrics"][k], e["metrics"][k])]
        unequal += [k for k in ("pix", "tgt") if not torch.equal(g[k], e[k])]
        row = dict(steps=GRAPH_STEPS, start=GRAPH_START, graphs=chunk.captures,
                   kinds=sorted(map(str, chunk.graphs)), unequal=unequal,
                   counts=g["counts"], eager_counts=e["counts"],
                   wall_s=g["wall_s"], eager_wall_s=e["wall_s"],
                   peak_gib=g["peak_gib"], eager_peak_gib=e["peak_gib"],
                   final_step=g["state"].step,
                   barf_alpha_last=float(g["metrics"]["barf-coarse"]))
        print(f"{name}: {chunk.captures} graphs (kinds {row['kinds']}); replayed steps equal to "
              f"the eager steps bit for bit: {not unequal}"
              + (f" (unequal: {unequal[:8]})" if unequal else "")
              + f"; launches {g['counts']} (eager {e['counts']}); wall {g['wall_s']:.3f} s "
              f"(eager {e['wall_s']:.3f} s, first steps and captures included); peak memory "
              f"above the start {g['peak_gib']:.3f} GiB (eager {e['peak_gib']:.3f} GiB)"
              + (f"; BARF alpha at the last step {row['barf_alpha_last']}"
                 if cfg.pos_enc == "barf" else ""))
        check(not unequal, f"graph phase, {name}: replayed steps differ from the eager steps "
                           f"({unequal[:8]})")
        check(g["counts"] == e["counts"], f"graph phase, {name}: launch counts {g['counts']} "
                                          f"!= the eager steps' {e['counts']}")
        check(chunk.captures >= 4, f"graph phase, {name}: {chunk.captures} graphs captured")
        print(f"{name}: eager step profile:")
        row["eager_profile"] = step_profile(torch, copy_state(src), rays, cfg)
        print(f"{name}: replayed step profile:")
        row["profile"] = step_profile(torch, copy_state(src), rays, cfg, graph=True)
        for key in ("eager_profile", "profile"):
            check(row[key]["host_waits_per_step"] == 0,
                  f"graph phase, {name}: a step waits for the device ({key})")
        pe, pg = row["eager_profile"], row["profile"]
        print(f"{name}: replayed {profile_row(pg)}; eager {profile_row(pe)}")
        del runs
        out[name] = row
    report["graph"] = out
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


def make_lca_dataset(torch) -> tuple:
    """The LCA dataset at full size, as the JAX LCA anchor made it
    (cli/datagen.py --data_name LCA --volume phantom:lca): the analytic LCA
    SDF volume through sdf_datagen_config, 26 views of 150 x 162, 2,000
    depth samples a ray, mode='sdf' DRRs, per-image normalization."""
    import numpy as np

    from nerf_for_angiography_tpu_torch.data import generate_dataset, make_lca_sdf_volume
    from nerf_for_angiography_tpu_torch.data.datasets import sdf_datagen_config

    volume, dcfg = make_lca_sdf_volume(), sdf_datagen_config()
    t0 = time.perf_counter()
    ds = generate_dataset(volume, dcfg, device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = dict(datagen_s=secs, rays=ds.rays.num_rays, views=int(ds.images.shape[0]),
               height=int(ds.images.shape[1]), width=int(ds.images.shape[2]),
               depth_samples=dcfg.depth_samples_per_ray, image_min=float(ds.images.min()),
               image_max=float(ds.images.max()), below_1=float((ds.images < 1.0).mean()))
    print(f"LCA datagen: {out['rays']} rays, {out['views']} views of {out['width']}x"
          f"{out['height']}, {out['depth_samples']} depth samples a ray, {secs:.2f} s; image "
          f"min {out['image_min']:.6f} max {out['image_max']:.6f}, share of pixels below 1 "
          f"{out['below_1']:.4f}")
    shape = (out["views"], out["height"], out["width"], out["depth_samples"])
    check(shape == LCA_SHAPE, f"the LCA dataset is {shape}, not {LCA_SHAPE} (views, height, "
                              "width, depth samples)")
    check(bool(np.isfinite(ds.images).all()) and out["image_min"] == 0.0
          and out["image_max"] == 1.0 and 0.0 < out["below_1"] < 1.0,
          "the LCA images are not finite, jointly normalized, with the tree in view")
    return ds, volume, dcfg, out


def lca_cpu_check(torch, volume, dcfg, angles) -> dict:
    """One view's SDF DRR on the card against device='cpu' on the same
    volume, rays and depths: within 1e-5."""
    from nerf_for_angiography_tpu_torch.data import render_drr
    from nerf_for_angiography_tpu_torch.geometry import get_ray_values, linspace_depths

    theta, phi = (float(a) for a in angles[LCA_CPU_VIEW])
    o, d, _ = get_ray_values(theta, phi, dcfg.larm, dcfg.src_pt, dcfg.img_width,
                             dcfg.img_height, dcfg.focal_length, device=DEVICE)
    z = linspace_depths(dcfg.near_thresh, dcfg.far_thresh, dcfg.depth_samples_per_ray, DEVICE)
    card = render_drr(volume.to(DEVICE), o, d, z, "sdf").cpu()
    t0 = time.perf_counter()
    cpu = render_drr(volume.to("cpu"), o.cpu(), d.cpu(), z.cpu(), "sdf")
    err = float((card - cpu).abs().max())
    out = dict(view=[theta, phi], max_abs_err=err, cpu_s=time.perf_counter() - t0,
               min=float(cpu.min()), max=float(cpu.max()))
    print(f"LCA view ({theta}, {phi}): card against CPU max abs {err:.3e} (limit 1e-5), "
          f"pixels {out['min']:.6f}..{out['max']:.6f}, CPU render {out['cpu_s']:.1f} s")
    check(err <= 1e-5, f"the card's SDF DRR differs from the CPU's by {err}")
    return out


def state_tensors(torch, state) -> dict:
    """Every tensor of a TrainState, copied to the host: parameters, Adam
    state, both grids, the generator state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    for name in ("grid", "vessel_grid"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name)._asdict().items()
                    if v is not None})
    out["generator"] = state.generator.get_state()
    return {k: v.detach().cpu().clone() for k, v in out.items()}


@contextlib.contextmanager
def recorded_evals(loop=None):
    """Within the block, every held-out eval that train() runs appends
    (iteration, held-out PSNR, vessel PSNR) to the yielded list; ``loop``
    is the training loop module whose make_eval_step is wrapped (the
    port's by default)."""
    loop = loop or importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    evals: list = []
    make = loop.make_eval_step

    def recording(*args, **kwargs):
        ev = make(*args, **kwargs)

        def run_eval(state, test):
            m, px = ev(state, test)
            evals.append((int(state.step) - 1, float(m["psnr/test-coarse"]),
                          float(m["psnr/vessel-test-coarse"])))
            return m, px

        return run_eval

    loop.make_eval_step = recording
    try:
        yield evals
    finally:
        loop.make_eval_step = make


@contextlib.contextmanager
def recorded_artifacts(torch):
    """Within the block, train() records what it writes: the best model's
    parameters at each highmodel.npz, the grids at each high*grid.vtk, and
    every tensor of the state at each resume checkpoint, copied at the
    moment of writing."""
    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    rec: dict = {"high_params": None, "high_grids": None, "ckpt": {}}
    save_model, export_grids, mgr = loop.save_model, loop._export_grids, loop.CheckpointManager

    def saving_model(path, definition, model, info=None):
        if path.endswith("highmodel.npz"):
            rec["high_params"] = {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()}
        return save_model(path, definition, model, info)

    def exporting(writer, log_dir, prefix, state):
        if prefix == "high":
            rec["high_grids"] = {"grid": state.grid.binary.cpu().clone(),
                                 "vesselgrid": state.vessel_grid.binary.cpu().clone(),
                                 "aabb": state.grid.aabb.cpu().clone()}
        return export_grids(writer, log_dir, prefix, state)

    class Recording(mgr):
        def save(self, step, state):
            rec["ckpt"][step] = state_tensors(torch, state)
            return super().save(step, state)

    loop.save_model, loop._export_grids, loop.CheckpointManager = saving_model, exporting, Recording
    try:
        yield rec
    finally:
        loop.save_model, loop._export_grids, loop.CheckpointManager = save_model, export_grids, mgr


def check_lca_artifacts(torch, ds, cfg, src_z: float, log_dir: str, res, rec: dict) -> dict:
    """highmodel.npz read back with load_model equals the best model bit for
    bit and re-renders the held-out view at the reported best held-out
    PSNR; high*grid.vtk read back equal to the grids written; the newest
    resume checkpoint restored into a fresh state equal to what was saved."""
    from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
    from nerf_for_angiography_tpu_torch.models import CPPN
    from nerf_for_angiography_tpu_torch.training import (
        CheckpointManager, create_train_state, load_grid_vtk, load_model, make_eval_step,
        make_test_view,
    )

    check(rec["high_params"] is not None, "LCA: no highmodel.npz was written")
    meta, params = load_model(os.path.join(log_dir, "highmodel.npz"))
    sd = cppn_params_from_jax(params)
    check(set(sd) == set(rec["high_params"])
          and all(torch.equal(sd[k], rec["high_params"][k]) for k in sd),
          "LCA: highmodel.npz is not the best model bit for bit")
    check(meta["training_information"]["step"] == res.best_iter,
          f"LCA: highmodel.npz is from iteration {meta['training_information']['step']}, the "
          f"best is {res.best_iter}")
    grids = {}
    for name in ("grid", "vesselgrid"):
        g = load_grid_vtk(os.path.join(log_dir, f"high{name}.vtk"), rec["high_grids"]["aabb"],
                          device=DEVICE)
        grids[name] = g
        check(torch.equal(g.binary.cpu(), rec["high_grids"][name]),
              f"LCA: high{name}.vtk does not read back as the grid it was written from")
    model = CPPN(cfg.model_config()).to(DEVICE)
    model.load_state_dict(sd)
    n_views = int(ds.rays.image_ids.max()) + 1
    test = make_test_view(ds.rays, n_views - 1, ds.rays.num_rays // n_views)
    dense = dataclasses.replace(cfg, compact_samples=0)
    near, far = src_z - cfg.outside, src_z + cfg.outside
    best = types.SimpleNamespace(
        grid=grids["grid"], step=res.best_iter + 1,
        step_dev=torch.tensor(res.best_iter + 1, dtype=torch.int32, device=DEVICE))
    metrics, _ = make_eval_step(model, dense, near, far)(best, test)
    psnr = float(metrics["psnr/test-coarse"])
    d_psnr = psnr - res.best_heldout_psnr
    print(f"LCA artifacts: highmodel.npz (iteration {res.best_iter}) equals the best model bit "
          f"for bit; re-rendered held-out PSNR {psnr:.6f} dB against the reported "
          f"{res.best_heldout_psnr:.6f} (difference {d_psnr:.2e}, limit 1e-4); highgrid.vtk and "
          f"highvesselgrid.vtk read back equal")
    check(abs(d_psnr) <= 1e-4, f"LCA: the bundle re-renders at {psnr} dB, the run reported "
                               f"{res.best_heldout_psnr}")

    mgr = CheckpointManager(os.path.join(log_dir, "ckpt"))
    steps = mgr.all_steps()
    check(steps == [LCA_EVERY, LCA_ITERS] and sorted(rec["ckpt"]) == steps,
          f"LCA: checkpoints {steps}, saved {sorted(rec['ckpt'])}, expected "
          f"{[LCA_EVERY, LCA_ITERS]}")
    _, fresh = create_train_state(cfg, seed=cfg.seed + 7, device=DEVICE)
    restored = mgr.restore(fresh)
    got, want = state_tensors(torch, restored), rec["ckpt"][steps[-1]]
    bad = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    print(f"LCA restore: {len(want)} tensors and the generator state of the step-{steps[-1]} "
          f"checkpoint (state.step {restored.step}) restored equal; unequal: {bad}")
    check(not bad and set(got) == set(want), f"LCA: restored tensors differ from the saved: {bad}")
    return dict(high_iter=res.best_iter, rerender_psnr=psnr, reported_psnr=res.best_heldout_psnr,
                checkpoints=steps, restored_step=restored.step, restored_tensors=len(want))


# the settled Tuning of the 20k LCA protocol (--lca-protocol): the default
# LCA run's 600 steps stop at lattice k = 192, so the kernels are also held
# at this Tuning's march of that run's trained grid
LCA_TWO_BUCKET = dict(mode="hybrid", k=192, w_cap=224, w_lo=160, k_lo=80)


def lca_kernel_checks(torch, fm, fk, cfg, src_z: float, state, rays, tunings: list,
                      label: str) -> dict:
    """Kernels #1, #2 and #5 against their plain versions at the shapes the
    LCA path gives them on ``state``, a trained LCA state: #1 at the
    held-out eval's dense render of the last view (one launch); for each
    distinct Tuning of ``tunings``, its step on a training batch marched on
    the trained grid (a two-bucket march's buckets concatenated, lo first,
    as the step's one MLP call takes them): #1 with random and the trained
    weights, #2 at random g and on the gradient the split composite hands it
    at the trained state (check_fwd's and check_bwd's limits), and #5 bit
    for bit on masks of the trained grid at every (R, w, k) the march
    launched."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import make_test_view
    from nerf_for_angiography_tpu_torch.training.train import _flat_positions, _march_for

    near, far = src_z - cfg.outside, src_z + cfg.outside
    packed, pbytes, gen = random_mlp(torch, fm)
    t_packed, t_pbytes = packed_of(torch, fm, state.model)
    n_views = int(rays.image_ids.max()) + 1
    test = make_test_view(rays, n_views - 1, rays.num_rays // n_views)
    p_eval = _flat_positions(_march_for(dataclasses.replace(cfg, compact_samples=0), state.grid,
                                        test.origins, test.directions, near, far)).shape[0]
    fwd = [check_fwd(torch, fm, packed, p_eval, gen, pbytes, f"{label} eval"),
           check_fwd(torch, fm, t_packed, p_eval, gen, t_pbytes,
                     f"{label} eval, trained weights")]
    bwd, fk_shapes = [], []
    batch = sample_pixel_rays(state.generator, rays, cfg.img_sample_size, impl="gumbel")
    plist = fm.cppn_params_to_list(state.model)
    kw = dict(step=(2 * cfg.outside) / cfg.depth_samples_per_ray,
              early_stop_eps=cfg.early_stop_eps, n_rays_loss=cfg.img_sample_size,
              input_scale=state.model.config.input_scale)
    keys = ("mode", "k", "w_cap", "w_lo", "k_lo")
    distinct = [t for i, t in enumerate(tunings)
                if all(any(t[q] != u[q] for q in keys) for u in tunings[:i])]
    for t in distinct:
        name = f"{label} " + (f"{t['mode']} k={t['k']}" if t["k"] else "dense") + (
            f" w_cap={t['w_cap']} w_lo={t['w_lo']} k_lo={t['k_lo']}" if t["w_lo"] else "")
        fk.reset_counts()
        m = _march_for(tuning_cfg(cfg, t), state.grid, batch.origins, batch.directions, near, far)
        fk_shapes += [s for s in sorted(fk.shapes) if s not in fk_shapes]
        xg = [split_raw_grad(torch, lambda x: fm.fused_mlp_raw(plist, x), *b, kw)
              for b in rect_blocks(m, batch.origins, batch.directions, batch.pixel_values)]
        x, g = torch.cat([a for a, _ in xg]), torch.cat([b for _, b in xg])
        p = _flat_positions(m).shape[0]
        check(x.shape[0] == p, f"{name}: the march blocks hold {x.shape[0]} points, the step {p}")
        fwd += [check_fwd(torch, fm, packed, p, gen, pbytes, f"{name} step"),
                check_fwd(torch, fm, t_packed, p, gen, t_pbytes, f"{name} step, trained weights")]
        tiles = torch.nn.functional.pad(g != 0, (0, (-p) % 16)).reshape(-1, 16).any(dim=1)
        share = float(tiles.float().mean())
        print(f"{name} step, trained state: {share:.4f} of the 16-point tiles have a non-zero g")
        bwd += [check_bwd(torch, fm, packed, p, gen, pbytes, f"{name} step"),
                dict(check_bwd(torch, fm, t_packed, p, None, t_pbytes,
                               f"{name} step, trained state", xg=(x, g)),
                     active_tile_share=share)]
    first_k = check_first_k(torch, fk, state.grid, cfg, batch, fk_shapes, src_z)
    for r in fwd:
        r.pop("x")
    print(f"{label}: kernel #1 held at {sorted({r['P'] for r in fwd})} points, #2 at "
          f"{sorted({r['P'] for r in bwd})}, #5 at {fk_shapes}")
    return dict(eval_p=p_eval, fwd=fwd, bwd=bwd, first_k=first_k)


def lca_phase(torch, fm, fk, fs, report: dict) -> tuple:
    """The LCA dataset at full size, one view against the CPU, 600 steps
    with log_dir and checkpoint_every (all six launch counters read around
    the run), the artifacts read back, and a resumed run. Returns the
    dataset, the run, and the volume and page_data the evaluation phase
    sweeps with."""
    import shutil

    from nerf_for_angiography_tpu_torch.training import lca_protocol, train

    ds, volume, dcfg, data = make_lca_dataset(torch)
    cpu = lca_cpu_check(torch, volume, dcfg, ds.angles)
    log_dir = os.path.join(HERE, "smoke_out", "lca_run")
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg, src_z = lca_protocol(n_iters=LCA_ITERS, display_every=LCA_EVERY)
    with recorded_artifacts(torch) as rec:
        run = compacted_run(torch, fm, fk, fs, ds, cfg, "lca", src_z=src_z, log_dir=log_dir,
                            checkpoint_every=LCA_EVERY)
    res = run.pop("result")
    print(f"lca: the chooser {'engaged' if run['compact_steps'] else 'never engaged'}: "
          f"first-k launched {run['first_k_launches']} times = {run['compact_steps']} compacted "
          f"steps x their Tunings' launches a step ({run['first_k_expected']} expected)")
    check(run["fwd_launches"] > 0 and run["bwd_launches"] > 0,
          "lca: kernel #1 or #2 never launched")
    check(run["fused_step_launches"] == 0 and run["enc_fwd_launches"] == 0
          and run["enc_bwd_launches"] == 0, "lca: kernel #3, #4 or #6 launched")
    names = sorted(os.listdir(log_dir))
    print(f"lca artifacts: {names}")
    arts = check_lca_artifacts(torch, ds, cfg, src_z, log_dir, res, rec)
    # the run's own Tunings (a dense step where the chooser had not engaged),
    # and the protocol's settled two-bucket one
    dense = [dict(mode=cfg.march_mode, k=0, w_cap=0, w_lo=0, k_lo=0)]
    tunings = ((dense if run["compact_steps"] < run["steps"] else [])
               + [{q: p[q] for q in ("mode", "k", "w_cap", "w_lo", "k_lo")}
                  for p in run["phases"]] + [LCA_TWO_BUCKET])
    kernels = lca_kernel_checks(torch, fm, fk, cfg, src_z, res.state, ds.rays, tunings, "lca")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res2 = train(dataclasses.replace(cfg, n_iters=LCA_RESUME_ITERS), ds.rays,
                     src_pt_z=src_z, log_dir=log_dir, checkpoint_every=LCA_EVERY,
                     verbose=True, device=DEVICE)
    out2 = buf.getvalue()
    print(out2, end="")
    want = f"resumed from checkpoint at step {LCA_ITERS + 1}"
    check(want in out2, f"lca resume: '{want}' not printed")
    check("carve_init:" not in out2, "lca resume: the resumed run carved its grids")
    check(res2.state.step == LCA_RESUME_ITERS + 1,
          f"lca resume: state.step {res2.state.step} != {LCA_RESUME_ITERS + 1}")
    print(f"lca resume: '{want}', no carve, state.step {res2.state.step} after iterations "
          f"{LCA_ITERS + 1}..{LCA_RESUME_ITERS}")
    out = dict(data=data, cpu_check=cpu, run=run, artifacts=arts, files=names, kernels=kernels,
               resume=dict(printed=want, carved=False, final_step=res2.state.step))
    report["lca"] = out
    return ds, run, dict(volume=volume, page_data=res.page_data)


def lca_protocol_phase(torch, fm, fk, ds, iters: int, report: dict) -> None:
    """The JAX LCA anchor's protocol (tools/lca_anchor.sh: cli/train.py
    --data_name LCA --n_iters N --display_every 1000 --compact_engage_max
    192, log_dir and checkpoint_every = save_every) on the in-memory dataset:
    the best-checkpoint held-out PSNR, its iteration, the last PSNR, the
    steady and end-to-end rates and the Tuning history; then kernels #1, #2
    and #5 at the shapes its final state gives them under every Tuning of
    that history (lca_kernel_checks)."""
    import shutil

    from nerf_for_angiography_tpu_torch.training import lca_protocol, train

    cfg, src_z = lca_protocol(n_iters=iters)
    log_dir = os.path.join(HERE, "smoke_out", "lca_protocol")
    shutil.rmtree(log_dir, ignore_errors=True)
    with (recorded_barf_alphas() as issued, recorded_schedule(issued) as sched,
          recorded_evals() as evals):
        res = train(cfg, ds.rays, src_pt_z=src_z, log_dir=log_dir,
                    checkpoint_every=cfg.save_every, verbose=True, device=DEVICE)
    t = res.timing
    tunings = [(kind, n, tt) for kind, n, tt in sched["tunings"]]
    out = dict(iters=iters, best_heldout_psnr=res.best_heldout_psnr, best_iter=res.best_iter,
               best_vessel_psnr=res.best_psnr, last_psnr=res.last_psnr,
               steady_rays_per_sec=t["steady_rays_per_sec"], rays_per_sec=res.rays_per_sec,
               total_s=t["total"], timing={k: v for k, v in t.items()
                                           if isinstance(v, (int, float))},
               tunings=tunings, steady_phases=t["steady_phases"], evals=evals,
               files=sorted(os.listdir(log_dir)))
    print(f"LCA protocol held-out PSNR by eval (iteration, dB): "
          f"{[(i, round(p, 3)) for i, p, _ in evals]}")
    print(f"LCA protocol {iters} steps: best-checkpoint held-out PSNR "
          f"{res.best_heldout_psnr:.3f} dB (iter {res.best_iter}; vessel {res.best_psnr:.3f}), "
          f"last {res.last_psnr:.3f} dB, steady {t['steady_rays_per_sec']:.0f} rays/s, end to "
          f"end {res.rays_per_sec:.0f} rays/s, {t['total']:.1f} s; Tunings (kind, iteration, "
          f"k) {[(kind, n, tt['k']) for kind, n, tt in tunings]}")
    check(math.isfinite(res.best_heldout_psnr), "LCA protocol: held-out PSNR not finite")
    out["kernels"] = lca_kernel_checks(torch, fm, fk, cfg, src_z, res.state, ds.rays,
                                       [tt for _, _, tt in tunings], "lca protocol")
    report["lca_protocol"] = out


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


# the evaluation phase (eval_phase): the sweeps run at the JAX defaults
# (EvalConfig(): 1,369 views of 100x100 in batches of 4, the field on a
# 201^3 lattice queried in chunks of EVAL_CHUNK points), which set the launch
# counts: kernel #1 once a batch and once a chunk, first-k (#5) once a CT batch
EVAL_CHUNK = 262_144
# the LCA sweep's run: the LCA protocol for this many steps. The LCA phase's
# 600-step state renders black under lca_eval_config() (the last sample's
# 1e10 segment; PERF.md section 6, PR 13), where every card-against-CPU
# limit would hold whatever kernel #1 returned; sweep_kernel_checks checks
# that this run's batch renders
LCA_SWEEP_ITERS = 2000
# one sweep batch rendered on the card against the CPU (a copy of the model
# and grid, the plain versions); pixels in [0, 1]. The median and the share
# of pixels beyond 1e-3, per-view PSNR in dB, SSIM / DOT 2D and DICE 2D
# (1e-3 is 10 of 10,000 binary pixels flipped at exactly 1.0): about 10x
# the largest readings on an H100 80GB HBM3 (PERF.md section 2). The max:
# about 10x the readings on rendering batches, CT 3.5e-5, LCA 2.088e-4 (the
# LCA sweep run's state)
EVAL_PIX_MAX = {"ct": 5e-4, "lca": 2e-3}
EVAL_PIX_MEDIAN, EVAL_PIX_SHARE = 1e-4, 1e-2
# the least share of the CPU batch's image pixels inside (0.02, 0.98), the
# range the port's card and CPU render tests hold
EVAL_PIX_LIVE = 1e-2
EVAL_PSNR_DB, EVAL_METRIC_ABS, EVAL_DICE_ABS = 1e-3, 1e-4, 1e-3
# a PNG pixel may sit one level off the uint8 of the table's pred_img, which
# the sweep rounds to 10 decimals after the PNG is written (as JAX does)
EVAL_PNG_LEVELS = 1
# the JAX TPU run's full 9x9 LCA sweep after 20k steps (benchmarks/LCA.md:
# 98-110), printed beside --lca-protocol's sweep as a record, not a gate
LCA_SWEEP_JAX = {"PSNR mean": (18.27, 18.39), "SSIM mean": 0.921, "DICE 2D mean": 0.886,
                 "DOT 2D mean": 0.947}


@contextlib.contextmanager
def recorded_eval_states(torch):
    """Within the block, every held-out eval that train() runs stores the
    model's parameters and the scene grid's occupancy at that iteration,
    copied on the card, under the iteration: the state highmodel.npz and
    highgrid.vtk would hold had the run a log_dir."""
    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    states: dict = {}
    make = loop.make_eval_step

    def recording(*args, **kwargs):
        ev = make(*args, **kwargs)

        def run_eval(state, test):
            out = ev(state, test)
            states[int(state.step) - 1] = dict(
                params={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                binary=state.grid.binary.clone(), aabb=state.grid.aabb.clone())
            return out

        return run_eval

    loop.make_eval_step = recording
    try:
        yield states
    finally:
        loop.make_eval_step = make


def model_and_grid(torch, snap: dict, cfg):
    """The port CPPN of ``cfg`` with a recorded eval state's parameters, and
    its grid as load_grid_vtk restores one (occs = binary)."""
    from nerf_for_angiography_tpu_torch.models import CPPN
    from nerf_for_angiography_tpu_torch.ops.occupancy import grid_from_numpy

    model = CPPN(cfg.model_config()).to(DEVICE)
    model.load_state_dict(snap["params"])
    model.requires_grad_(False)
    b = snap["binary"].cpu().numpy()
    return model, grid_from_numpy(b, snap["aabb"].cpu().numpy(), occs=b.astype("float32"),
                                  device=DEVICE)


@contextlib.contextmanager
def recorded_field():
    """Within the block, every field the sweep's export_field_vtk returns is
    appended to the yielded list."""
    sweep = importlib.import_module("nerf_for_angiography_tpu_torch.evaluation.sweep")
    fields: list = []
    export = sweep.export_field_vtk

    def recording(*args, **kwargs):
        fields.append(export(*args, **kwargs))
        return fields[-1]

    sweep.export_field_vtk = recording
    try:
        yield fields
    finally:
        sweep.export_field_vtk = export


def grid_to(grid, device):
    return type(grid)(*(t.to(device) if t is not None else None for t in grid))


def view_scores(torch, p3, b3, tgt) -> dict:
    """The sweep's per-view metrics of a batch, as numpy."""
    from nerf_for_angiography_tpu_torch.evaluation import metrics as mt

    return {"PSNR": mt.psnr_views(p3, tgt), "SSIM": mt.ssim(p3, tgt),
            "DICE 2D": mt.dice_micro_views(mt.binarize(b3), mt.binarize(tgt)),
            "DOT 2D": mt.dot_score_views(p3, tgt)}


def sweep_kernel_checks(torch, fm, fk, model, grid, cfg, gt, label: str) -> dict:
    """The sweep's kernels at its shapes: the first batch of views rendered
    on the card and on the CPU (copies of the model and grid: the plain
    versions), pixels and per-view metrics held within the EVAL_* limits;
    kernel #1 against its plain version at the batch's point count and the
    field's chunks (random and the loaded weights); the CT branch's first-k
    (#5) bit for bit on the batch's march mask at k = compact_samples. The
    per-view metrics score both renders against ``gt``'s targets."""
    import copy

    import numpy as np

    from nerf_for_angiography_tpu_torch.evaluation import sweep as st
    from nerf_for_angiography_tpu_torch.ops.occupancy import march_rays
    from nerf_for_angiography_tpu_torch.training import TrainConfig
    from nerf_for_angiography_tpu_torch.training.train import _stride_for

    angles = st.sweep_angles(cfg)
    t360, p360 = st._angles_360(angles)
    b = max(1, cfg.chunk_views)
    H, W = cfg.img_height, cfg.img_width
    card = st.make_batch_view_renderer(model, grid, cfg)
    px, bpx, _ = card(grid, t360[:b], p360[:b])
    # the CPU render: one view for LCA (its plain MLP at the full batch's
    # 19,440,000 points would hold ~35 GB of activations on the host)
    n_cpu = b if cfg.data_name == "ct" else 1
    model_cpu = copy.deepcopy(model).to("cpu")
    grid_cpu = grid_to(grid, "cpu")
    t0 = time.perf_counter()
    cpx, cbpx, _ = st.make_batch_view_renderer(model_cpu, grid_cpu, cfg)(
        grid_cpu, t360[:n_cpu], p360[:n_cpu])
    cpu_s = time.perf_counter() - t0
    pe = torch.cat([(px[:n_cpu].cpu() - cpx).abs().reshape(-1),
                    (bpx[:n_cpu].cpu() - cbpx).abs().reshape(-1)])
    pix_max, pix_med = float(pe.max()), float(pe.median())
    pix_share = float((pe > 1e-3).float().mean())
    lim_max = EVAL_PIX_MAX[cfg.data_name.lower()]
    # the compared views must render: on an all-black (or all-white) image
    # every limit below holds whatever kernel #1 returns. The binary image
    # may be all white: at the CT defaults no sigma of the vessel phantom
    # (mu 0.03) reaches binary_thresh 0.05
    live, blive = (float(((x > 0.02) & (x < 0.98)).float().mean()) for x in (cpx, cbpx))
    # per-view metrics of both renders against the same targets (the card's GT)
    tgt = torch.from_numpy(
        np.stack([np.asarray(gt(t360[i], p360[i]), np.float32).reshape(H, W)
                  for i in range(n_cpu)]))
    got = view_scores(torch, px[:n_cpu].cpu().reshape(-1, H, W),
                      bpx[:n_cpu].cpu().reshape(-1, H, W), tgt)
    want = view_scores(torch, cpx.reshape(-1, H, W), cbpx.reshape(-1, H, W), tgt)
    d_metric = {m: float((got[m] - want[m]).abs().max()) for m in got}
    lim_metric = {"PSNR": EVAL_PSNR_DB, "SSIM": EVAL_METRIC_ABS, "DICE 2D": EVAL_DICE_ABS,
                  "DOT 2D": EVAL_METRIC_ABS}
    print(f"{label} sweep batch ({n_cpu} of {b} views on the CPU, {cpu_s:.1f} s): pixels inside "
          f"(0.02, 0.98) {live:.4f} (at least {EVAL_PIX_LIVE}), binary {blive:.4f}; card against "
          f"CPU pixels max abs {pix_max:.3e} (limit {lim_max}) median {pix_med:.3e} (limit "
          f"{EVAL_PIX_MEDIAN}), share beyond 1e-3 {pix_share:.3e} (limit {EVAL_PIX_SHARE}); "
          f"per-view metric max abs differences "
          + ", ".join(f"{m} {v:.3e} (limit {lim_metric[m]})" for m, v in d_metric.items()))
    check(live >= EVAL_PIX_LIVE, f"{label} sweep: the compared batch hardly renders ({live:.4f} "
                                 f"of its pixels inside (0.02, 0.98))")
    check(pix_max <= lim_max and pix_med <= EVAL_PIX_MEDIAN and pix_share <= EVAL_PIX_SHARE,
          f"{label} sweep: the card's batch render differs from the CPU's")
    check(all(v <= lim_metric[m] for m, v in d_metric.items()),
          f"{label} sweep: per-view metrics differ between the card and the CPU {d_metric}")

    packed, pbytes, gen = random_mlp(torch, fm)
    t_packed, t_pbytes = packed_of(torch, fm, model)
    n = cfg.depth_samples_per_ray
    if cfg.data_name == "ct":
        tc = TrainConfig(depth_samples_per_ray=n, outside=cfg.outside,
                         grid_resolution=grid.resolution, march_mode="lattice")
        rays = [st.get_ray_values(float(t), float(p), 0.0, cfg.src_pt, W, H, cfg.focal_length,
                                  device=DEVICE) for t, p in zip(t360[:b], p360[:b])]
        o = torch.cat([r[0].reshape(-1, 3) for r in rays])
        d = torch.cat([r[1].reshape(-1, 3) for r in rays])
        near, far = cfg.near_thresh, cfg.far_thresh
        mask = march_rays(grid, o, d, n, near, far, occ_stride=_stride_for(tc, near, far)).mask
        fk_rows = [first_k_row(torch, fk, mask, tc.compact_samples)]
        p_batch = o.shape[0] * tc.compact_samples
    else:
        fk_rows = []
        p_batch = b * H * W * n
    n_field = cfg.field_resolution ** 3
    p_last = n_field - (math.ceil(n_field / EVAL_CHUNK) - 1) * EVAL_CHUNK
    fwd = []
    for p, what in ((p_batch, "batch"), (EVAL_CHUNK, "field chunk"), (p_last, "last field chunk")):
        fwd += [check_fwd(torch, fm, packed, p, gen, pbytes, f"{label} sweep {what}"),
                check_fwd(torch, fm, t_packed, p, gen, t_pbytes,
                          f"{label} sweep {what}, loaded weights")]
    for r in fwd:
        r.pop("x")
    return dict(batch_views_cpu=n_cpu, cpu_s=cpu_s, pix_live_share=live,
                binary_live_share=blive, pix_max_abs=pix_max, pix_median_abs=pix_med,
                pix_share_beyond_1e3=pix_share, metric_max_abs=d_metric, fwd=fwd, first_k=fk_rows, batch_points=p_batch)


def hemisphere_angle_files(table, cfg) -> set:
    """The per-angle JSON names of the top and bottom X-Z hemispheres."""
    from nerf_for_angiography_tpu_torch.evaluation import hemisphere_mask

    names = set()
    for nm in ("top", "bottom"):
        sel = hemisphere_mask(table["theta"], table["phi"], "X", "Z", nm)
        names |= {f"{t:.1f}{p:.1f}.json" for t, p in zip(table["theta"][sel],
                                                          table["phi"][sel])}
    return names


def check_videos(label: str, table: dict, proj: str, cfg) -> int:
    """The rotation videos run_sweep wrote, read back: for each rotation and
    kind, the .mp4 that save_video muxes (an ISO-BMFF 'ftyp' box first, one
    JPEG a view, the first decoding at the view's size) and the .gif beside
    it (its first frame the uint8 of the first view's image; consecutive
    equal frames merge, so it holds at most one a view). Returns the number
    of files checked."""
    import io

    import numpy as np
    from PIL import Image

    H, W = cfg.img_height, cfg.img_width
    u8 = {"gt": lambda i: table["org_img"][i],
          "pred": lambda i: table["pred_img"][i],
          "diff": lambda i: np.abs(table["org_img"][i] - table["pred_img"][i]),
          "binary": lambda i: table["binary_pred_img"][i]}
    n = 0
    for title, axis in (("theta-rotation", "phi"), ("phi-rotation", "theta")):
        rows = np.flatnonzero(table[axis] == 0.0)
        for kind, img in u8.items():
            path = os.path.join(proj, f"{title}-{kind}.mp4")
            check(os.path.exists(path), f"{label}: {path} was not written")
            with open(path, "rb") as f:
                data = f.read()
            check(len(data) > 8 and data[4:8] == b"ftyp", f"{label}: {path} is not an MP4")
            check(data.count(b"\xff\xd8\xff") == len(rows),
                  f"{label}: {path} does not hold one JPEG for each of {len(rows)} views")
            s = data.index(b"\xff\xd8\xff")
            first = Image.open(io.BytesIO(data[s:data.index(b"\xff\xd9", s) + 2]))
            check(first.size == (W, H), f"{label}: {path}'s first frame is {first.size}")
            gif = path[:-4] + ".gif"
            check(os.path.exists(gif), f"{label}: {gif} was not written")
            with open(gif, "rb") as f:
                check(f.read(6) == b"GIF89a", f"{label}: {gif} is not a GIF")
            g = Image.open(gif)
            want = (255 * np.clip(img(rows[0]), 0, 1)).astype(np.uint8).reshape(H, W)
            check(g.size == (W, H) and 1 <= g.n_frames <= len(rows)
                  and np.array_equal(np.asarray(g.convert("L")), want),
                  f"{label}: {gif} is not the rotation's {kind} frames")
            n += 2
    return n


def check_sweep_artifacts(torch, label: str, table: dict, out_dir: str, cfg, field, columns,
                          heat: list, page_data, calibrated) -> dict:
    """Every artifact of a sweep read back: the CSV (JAX's header, one row a
    view), every PNG (its signature, the uint8 of the table's image),
    metrics-summary.txt's keys, coarse-field.vtk equal to the returned
    field, each metric's top / bottom JSON and every per-angle JSON of both
    hemispheres with cag-vis's keys, and with save_videos the rotation
    videos (check_videos)."""
    import csv

    import numpy as np

    from nerf_for_angiography_tpu_torch.evaluation import experiment_naming
    from nerf_for_angiography_tpu_torch.evaluation.sweep import METRIC_COLUMNS
    from nerf_for_angiography_tpu_torch.utils import read_png_gray, read_vtk

    t0 = time.perf_counter()
    n, hw = len(table["theta"]), cfg.img_height * cfg.img_width
    with open(os.path.join(out_dir, "df-metrics.csv")) as f:
        rows = list(csv.reader(f, delimiter=";"))
    header = [""] + list(columns)
    check(rows[0] == header, f"{label}: df-metrics.csv header {rows[0]} != {header}")
    check(len(rows) == n + 1 and all(len(r) == len(header) for r in rows[1:]),
          f"{label}: df-metrics.csv has {len(rows) - 1} rows, not {n}")
    metric_cols = [c for c in columns if c in METRIC_COLUMNS]
    for m in metric_cols:
        v = np.asarray(table[m], float)
        check(v.shape == (n,) and bool(np.isfinite(v).all()), f"{label}: {m} not finite")
    for c in ("pred_img", "binary_pred_img", "org_img"):
        check(table[c].shape == (n, hw) and bool(np.isfinite(table[c]).all()),
              f"{label}: {c} is not finite of shape {(n, hw)}")

    proj = os.path.join(out_dir, "projections")
    pngs = sorted(f for f in os.listdir(proj) if f.endswith(".png"))
    check(len(pngs) == 2 * n, f"{label}: {len(pngs)} projection PNGs, not {2 * n}")
    off = 0
    for i, (theta, phi) in enumerate(zip(table["theta"], table["phi"])):
        for suffix, col in (("", "pred_img"), ("-binary", "binary_pred_img")):
            path = os.path.join(proj, f"image-{theta}-{phi}-0{suffix}.png")
            with open(path, "rb") as f:
                check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{label}: {path} is not a PNG")
            img = read_png_gray(path).astype(np.int32)
            want = (np.clip(table[col][i], 0.0, 1.0) * 255).astype(np.uint8).reshape(img.shape)
            diff = np.abs(img - want.astype(np.int32))
            check(int(diff.max()) <= EVAL_PNG_LEVELS, f"{label}: {path} is not the view's image")
            off += int((diff > 0).sum())
    videos = check_videos(label, table, proj, cfg) if cfg.save_videos else 0

    summary = dict(ln.split("=", 1)
                   for ln in open(os.path.join(out_dir, "metrics-summary.txt")).read().splitlines())
    keys = [f"{m} {q}" for m in metric_cols for q in ("min", "mean", "std")]
    check(list(summary) == keys, f"{label}: metrics-summary.txt keys {list(summary)} != {keys}")

    g = read_vtk(os.path.join(out_dir, "coarse-field.vtk"))
    r = cfg.field_resolution
    check(g.dimensions == (r, r, r) and np.array_equal(g.scalars_3d(), field),
          f"{label}: coarse-field.vtk does not read back as the returned field")

    exp, name = experiment_naming(page_data or {}, cfg.center_point)
    folder = os.path.join(out_dir, "jsonData", exp, name)
    files = set(os.listdir(folder))
    for m in heat:
        for nm in ("top", "bottom"):
            with open(os.path.join(folder, f"{m}-{nm}-X-Z.json")) as f:
                obj = json.load(f)
            want_keys = {"rad", "theta", "angles", "vals"} | (
                {"calibrated"} if m in ("LPIPS", "DISTS") and calibrated is False else set())
            check(set(obj) == want_keys and len(obj["vals"]) == len(obj["angles"]) > 0
                  and obj.get("calibrated", False) is False,
                  f"{label}: {m}-{nm}-X-Z.json keys {sorted(obj)} != {sorted(want_keys)}")
    angle_files = hemisphere_angle_files(table, cfg)
    check(angle_files <= files, f"{label}: per-angle JSONs missing: "
                                f"{sorted(angle_files - files)[:5]}")
    index = {f"{t:.1f}{p:.1f}.json": i for i, (t, p) in enumerate(zip(table["theta"],
                                                                       table["phi"]))}
    for fname in sorted(angle_files):
        with open(os.path.join(folder, fname)) as f:
            obj = json.load(f)
        i = index[fname]
        check(set(obj) == {"pred", "org", "diff"} and len(obj["pred"]) == hw
              and obj["pred"] == table["pred_img"][i].astype(float).tolist()
              and obj["org"] == table["org_img"][i].astype(float).tolist(),
              f"{label}: {fname} is not the view's pred / org / diff")
    secs = time.perf_counter() - t0
    print(f"{label} artifacts: df-metrics.csv {n} rows with JAX's {len(header)}-column header; "
          f"{len(pngs)} PNGs read back ({off} pixels one level off the rounded table); "
          f"metrics-summary.txt {len(keys)} keys; coarse-field.vtk {r}^3 equal to the field; "
          f"{2 * len(heat)} heatmap JSONs ({', '.join(heat)}) and {len(angle_files)} per-angle "
          f"JSONs with cag-vis's keys; {videos} rotation video files read back; checked in "
          f"{secs:.1f} s")
    return dict(csv_rows=n, header=header, pngs=len(pngs), png_pixels_one_level_off=off,
                summary_keys=len(keys), heatmap_jsons=2 * len(heat),
                angle_jsons=len(angle_files), video_files=videos, check_s=secs)


def sweep_run(torch, fm, fk, fs, label: str, model, grid, cfg, volume, gt, out_dir: str,
              page_data, perceptual, columns: list) -> dict:
    """One run_sweep with all six launch counters set to 0 just before it
    and read just after (kernel #1 once a batch and once a field chunk,
    first-k once a CT batch, #2/#3/#4/#6 never), its seconds by part and
    peak device memory; without matplotlib the heatmap JSONs come from
    export_heatmaps(save_png=False) after it; then every artifact read
    back. ``volume`` (on the card) samples the GT field, ``gt`` renders
    the GT views."""
    import shutil

    import numpy as np

    from nerf_for_angiography_tpu_torch.evaluation import run_sweep, sweep_angles
    from nerf_for_angiography_tpu_torch.evaluation.sweep import export_heatmaps
    from nerf_for_angiography_tpu_torch.ops.interpolation import trilinear

    shutil.rmtree(out_dir, ignore_errors=True)
    n_views = len(sweep_angles(cfg))
    batches = math.ceil(n_views / max(1, cfg.chunk_views))
    chunks = math.ceil(cfg.field_resolution ** 3 / EVAL_CHUNK)
    want = dict(fwd_launches=batches + chunks,
                first_k_launches=batches if cfg.data_name == "ct" else 0,
                bwd_launches=0, fused_step_launches=0, enc_fwd_launches=0, enc_bwd_launches=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timing: dict = {}
    reset_all(fm, fk, fs)
    t0 = time.perf_counter()
    with recorded_field() as fields:
        table = run_sweep(model, grid, cfg, gt, out_dir, page_data=page_data,
                          perceptual=perceptual, gt_volume_sampler=lambda p: trilinear(volume, p),
                          verbose=False, device=DEVICE, timing=timing)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = read_counts(fm, fk, fs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    heat = [c for c in table if c in ("PSNR", "SSIM", "DICE 2D", "DOT 2D", "LPIPS", "DISTS")]
    if not cfg.save_heatmap:
        t1 = time.perf_counter()
        heat = export_heatmaps(table, cfg, out_dir, page_data, perceptual, save_png=False)
        timing["json"] = time.perf_counter() - t1
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in timing.items())
    print(f"{label} sweep: {n_views} views of {cfg.img_width}x{cfg.img_height} in {batches} "
          f"batches of {cfg.chunk_views}, {cfg.depth_samples_per_ray} samples a ray, field "
          f"{cfg.field_resolution}^3 in {chunks} chunks: {sweep_s:.2f} s ({parts}); launches "
          f"fwd {counts['fwd_launches']} (expected {want['fwd_launches']}) first_k "
          f"{counts['first_k_launches']} (expected {want['first_k_launches']}) bwd "
          f"{counts['bwd_launches']} fused_step {counts['fused_step_launches']} enc_fwd "
          f"{counts['enc_fwd_launches']} enc_bwd {counts['enc_bwd_launches']}; peak device "
          f"memory {peak:.3f} GiB allocated ({mem0 / 2**30:.3f} GiB before)")
    check(counts == want, f"{label} sweep: launches {counts} != {want}")
    check(len(fields) == 1, f"{label} sweep: {len(fields)} field exports, not 1")
    summary = {m: {q: float(f(np.asarray(table[m], float))) for q, f in
                   (("min", np.min), ("mean", np.mean), ("std", np.std))} for m in heat}
    summary.update({m: float(table[m][0]) for m in ("DICE 3D", "DOT 3D") if m in table})
    print(f"{label} sweep metrics: " + "; ".join(
        f"{m} " + (f"{v:.6f}" if isinstance(v, float) else
                   f"min {v['min']:.4f} mean {v['mean']:.4f} std {v['std']:.4f}")
        for m, v in summary.items()))
    arts = check_sweep_artifacts(torch, label, table, out_dir, cfg, fields[0], columns, heat,
                                 page_data, None if perceptual is None else perceptual.calibrated)
    return dict(**counts, expected=want, views=n_views, batches=batches, field_chunks=chunks,
                sweep_s=sweep_s, seconds_by_part=timing, peak_allocated_gib=peak,
                before_gib=mem0 / 2**30, metrics=summary, artifacts=arts)


def eval_artifacts_available() -> dict:
    """Whether the card's Python has PIL (videos) and matplotlib (the
    heatmap PNGs); the sweeps turn off what it lacks."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib")}


SWEEP_COLUMNS = ["image_id", "theta", "phi", "larm", "theta_360", "phi_360", "cam_pose_x",
                 "cam_pose_y", "cam_pose_z", "PSNR", "SSIM", "DICE 2D", "DOT 2D"]


def lca_sweep_run(torch, ds) -> tuple[str, dict]:
    """The LCA sweep's state: LCA_SWEEP_ITERS steps of the LCA protocol on
    the LCA dataset ``ds``, written under smoke_out/lca_sweep_run. Returns
    the run directory and its page_data."""
    import shutil

    from nerf_for_angiography_tpu_torch.training import lca_protocol, train

    log_dir = os.path.join(HERE, "smoke_out", "lca_sweep_run")
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg, src_z = lca_protocol(n_iters=LCA_SWEEP_ITERS)
    t0 = time.perf_counter()
    res = train(cfg, ds.rays, src_pt_z=src_z, log_dir=log_dir, verbose=False, device=DEVICE)
    print(f"lca sweep run: {LCA_SWEEP_ITERS} steps of the LCA protocol in "
          f"{time.perf_counter() - t0:.1f} s, best held-out PSNR {res.best_heldout_psnr:.3f} dB "
          f"at iteration {res.best_iter}")
    return log_dir, res.page_data


def eval_phase(torch, fm, fk, fs, ct_best: dict, ct_page: dict, lca_ds, lca_info: dict,
               report: dict) -> dict:
    """The evaluation phase: the JAX defaults' CT sweep (EvalConfig(): all
    eight metrics, LPIPS / DISTS on the uncalibrated backend) on the best
    state of the shipped 600-step run, with GT from the vessel volume, and
    the LCA sweep (lca_eval_config(): DICE 3D / DOT 3D from the LCA volume)
    on the best state of lca_sweep_run loaded by
    Reconstruction.from_run_dir, whose render_view must equal
    render_view_pair bit for bit; the sweep's kernels at its shapes before
    each sweep (sweep_kernel_checks)."""
    import numpy as np

    from nerf_for_angiography_tpu_torch.data import make_vessel_volume
    from nerf_for_angiography_tpu_torch.evaluation import (
        EvalConfig, PerceptualMetrics, gt_from_volume, lca_eval_config, render_view_pair,
    )
    from nerf_for_angiography_tpu_torch.reconstruction import Reconstruction
    from nerf_for_angiography_tpu_torch.training import TrainConfig

    have = eval_artifacts_available()
    flags = dict(save_videos=have["PIL"], save_heatmap=have["matplotlib"])
    for mod, what in (("PIL", "the rotation videos (save_videos=False)"),
                      ("matplotlib", "the polar heatmap PNGs (save_heatmap=False; the cag-vis "
                                     "JSONs come from export_heatmaps(save_png=False))")):
        print(f"eval: {mod} {'imports' if have[mod] else 'is not installed'}"
              + ("" if have[mod] else f": skipping {what}"))
    out = dict(available=have, flags=flags)

    model, grid = model_and_grid(torch, ct_best, TrainConfig())
    cfg = EvalConfig(**flags)
    vessel = make_vessel_volume(res=96, device=DEVICE)  # bench.py's phantom, as make_dataset
    perceptual = PerceptualMetrics.uncalibrated(device=DEVICE)
    gt = gt_from_volume(vessel, cfg)
    out["ct_kernels"] = sweep_kernel_checks(torch, fm, fk, model, grid, cfg, gt, "ct")
    out["ct"] = sweep_run(torch, fm, fk, fs, "ct", model, grid, cfg, vessel, gt,
                          os.path.join(HERE, "smoke_out", "eval_ct"), ct_page, perceptual,
                          SWEEP_COLUMNS + ["LPIPS", "DISTS", "DICE 3D", "DOT 3D",
                                           "perceptual_calibrated"])

    lca_dir, lca_page = lca_sweep_run(torch, lca_ds)
    rec = Reconstruction.from_run_dir(lca_dir, data_name="LCA",
                                      eval_config=lca_eval_config(**flags), device=DEVICE)
    img = rec.render_view(-30.0, 40.0)
    pair, _, _ = render_view_pair(rec.model, rec.grid, rec.eval_config, 330.0, 40.0,
                                  device=DEVICE)
    same = bool(np.array_equal(img, pair))
    print(f"Reconstruction.from_run_dir({os.path.relpath(lca_dir, HERE)}, "
          f"data_name='LCA'): render_view(-30, 40) {img.shape} equals render_view_pair(330, 40) "
          f"bit for bit {same}; pixels {img.min():.4f}..{img.max():.4f}")
    check(same and bool(np.isfinite(img).all()),
          "Reconstruction.render_view differs from render_view_pair")
    out["reconstruction"] = dict(equal=same, shape=list(img.shape))
    lcfg = rec.eval_config
    lca_volume = lca_info["volume"].to(DEVICE)
    gt = gt_from_volume(lca_volume, lcfg)
    out["lca_kernels"] = sweep_kernel_checks(torch, fm, fk, rec.model, rec.grid, lcfg, gt,
                                             "lca")
    out["lca"] = sweep_run(torch, fm, fk, fs, "lca", rec.model, rec.grid, lcfg, lca_volume,
                           gt, os.path.join(HERE, "smoke_out", "eval_lca"), lca_page, None,
                           SWEEP_COLUMNS + ["DICE 3D", "DOT 3D"])
    report["eval"] = out
    return out


def lca_protocol_sweep(torch, fm, fk, fs, lca_info: dict, report: dict) -> None:
    """With --lca-protocol: the protocol's best state swept at
    benchmarks/LCA.md:98-130's settings (a 9x9 sweep, 51^3 field), its
    summary printed beside the JAX TPU run's as a record."""
    from nerf_for_angiography_tpu_torch.evaluation import gt_from_volume, lca_eval_config
    from nerf_for_angiography_tpu_torch.reconstruction import Reconstruction

    have = eval_artifacts_available()
    cfg = lca_eval_config(number_angles_vis=8.0, field_resolution=51,
                          save_videos=have["PIL"], save_heatmap=have["matplotlib"])
    rec = Reconstruction.from_run_dir(os.path.join(HERE, "smoke_out", "lca_protocol"),
                                      data_name="LCA", eval_config=cfg, device=DEVICE)
    volume = lca_info["volume"].to(DEVICE)
    run = sweep_run(torch, fm, fk, fs, "lca protocol", rec.model, rec.grid, cfg, volume,
                    gt_from_volume(volume, cfg), os.path.join(HERE, "smoke_out", "eval_lca_protocol"),
                    lca_info["page_data"], None, SWEEP_COLUMNS + ["DICE 3D", "DOT 3D"])
    m = run["metrics"]
    print(f"LCA protocol 9x9 sweep: PSNR mean {m['PSNR']['mean']:.4f} (JAX TPU run "
          f"{LCA_SWEEP_JAX['PSNR mean'][0]}-{LCA_SWEEP_JAX['PSNR mean'][1]}), SSIM mean "
          f"{m['SSIM']['mean']:.4f} ({LCA_SWEEP_JAX['SSIM mean']}), DICE 2D mean "
          f"{m['DICE 2D']['mean']:.4f} ({LCA_SWEEP_JAX['DICE 2D mean']}), DOT 2D mean "
          f"{m['DOT 2D']['mean']:.4f} ({LCA_SWEEP_JAX['DOT 2D mean']}); a record, not a gate")
    report["lca_protocol_sweep"] = run


def build_native() -> dict:
    """Build the two native host libraries (native/csv_loader.cpp,
    native/json_export.cpp) with the host C++ compiler; seconds of each."""
    from nerf_for_angiography_tpu_torch import native

    secs = {}
    for name in ("csvloader", "jsonexport"):
        t0 = time.perf_counter()
        native.get_lib(name)
        secs[name] = time.perf_counter() - t0
    print("native host library builds: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    return secs


CLI_NAMES = ("datagen", "train", "evaluate", "analyze")
CLI_TRAIN_ARGV = ["--n_iters", "600", "--display_every", "300"]
CLI_SWEEP = (1369, 703)  # the 37x37 sweep's views and its per-angle JSONs
CLI_COLUMNS = SWEEP_COLUMNS + ["LPIPS", "DISTS", "DICE 3D", "DOT 3D", "perceptual_calibrated"]


def cli_help(root: str) -> dict:
    """`python -m nerf_for_angiography_tpu_torch.cli.<name> --help` for the
    four entry points, as four processes started together: each must import
    (the card has no JAX) and print its usage."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"nerf_for_angiography_tpu_torch.cli.{name}", "--help"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in CLI_NAMES}
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=300)
        out[name] = proc.returncode
        check(proc.returncode == 0 and "usage:" in text,
              f"cli.{name} --help exited {proc.returncode}:\n{text[-2000:]}")
    print(f"cli --help: {', '.join(CLI_NAMES)} each start and print their usage "
          f"({time.perf_counter() - t0:.1f} s, four processes)")
    return out


def check_rays_equal(torch, loaded, ds, label: str) -> None:
    for f in ("origins", "directions", "pixel_values", "weights", "image_ids", "x_positions",
              "y_positions"):
        a, b = getattr(loaded.rays, f), getattr(ds.rays, f)
        check(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b),
              f"{label}: the CSVs' {f} differ from the in-memory dataset's")


def cli_datagen(torch, argv: list, ds, label: str, tag: str) -> dict:
    """One datagen CLI run: its files (two CSVs, a gray and a weight-map PNG
    a view, both VTKs) and the rays load_data reads from its CSVs, which must
    equal the in-memory dataset ``ds`` of the same configuration bit for
    bit; the first view's PNGs read back as the writers make them."""
    import numpy as np

    from nerf_for_angiography_tpu_torch.cli import datagen
    from nerf_for_angiography_tpu_torch.data import load_data
    from nerf_for_angiography_tpu_torch.utils import (
        colormap_rgba, read_png_gray, read_png_rgba, read_vtk,
    )

    t0 = time.perf_counter()
    paths = datagen.main(argv)
    secs = time.perf_counter() - t0
    folder = paths["folder"]
    check(os.path.basename(paths["proj_csv"]).endswith(f"-{tag}.csv"),
          f"{label}: {paths['proj_csv']} is not a {tag} CSV")
    pngs = sorted(os.listdir(os.path.join(folder, "projections")))
    views = len(ds.angles)
    n_wmap = sum(p.startswith("image-transform-") for p in pngs)
    check(len(pngs) == 2 * views and n_wmap == views,
          f"{label}: {len(pngs)} PNGs ({n_wmap} weight maps) for {views} views")
    gt = read_vtk(os.path.join(folder, "ground-truth.vtk"))
    check(gt.dimensions == (200, 200, 200) and os.path.exists(
        os.path.join(folder, "transferfunc.vtk")), f"{label}: the VTKs were not written")
    (theta, phi), img, wmap = ds.angles[0], ds.images[0], ds.weight_maps[0]
    gray = read_png_gray(os.path.join(folder, "projections", f"image-{theta}-{phi}-0.0.png"))
    rgba = read_png_rgba(os.path.join(folder, "projections",
                                      f"image-transform-{theta}-{phi}-0.0.png"))
    check(np.array_equal(gray, (np.clip(img, 0, 1) * 255).astype(np.uint8))
          and np.array_equal(rgba, colormap_rgba(wmap)),
          f"{label}: the first view's PNGs are not its image and weight map")
    t1 = time.perf_counter()
    loaded = load_data(paths["proj_csv"], paths["rays_csv"], device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    check_rays_equal(torch, loaded, ds, label)
    sizes = {k: os.path.getsize(paths[k]) / 2**20 for k in ("proj_csv", "rays_csv")}
    print(f"{label} datagen CLI: {views} views, {ds.rays.num_rays} rays in {secs:.2f} s; "
          f"{len(pngs)} PNGs, ground-truth.vtk 200^3, transferfunc.vtk; "
          f"{os.path.basename(paths['proj_csv'])} {sizes['proj_csv']:.1f} MiB, "
          f"{os.path.basename(paths['rays_csv'])} {sizes['rays_csv']:.1f} MiB; load_data "
          f"(native) {load_s:.2f} s: every ray array torch.equal to the in-memory dataset")
    return dict(datagen_s=secs, load_s=load_s, views=views, rays=ds.rays.num_rays, pngs=len(pngs),
                csv_mib=sizes, proj_csv=paths["proj_csv"], rays_csv=paths["rays_csv"])


def cli_vtk_datagen(torch) -> dict:
    """The datagen CLI on a CT volume read from a STRUCTURED_POINTS file: the
    grid it loads holds transfer_func_ct of the raw values at every node,
    and its CSVs load."""
    import numpy as np

    from nerf_for_angiography_tpu_torch.cli import datagen
    from nerf_for_angiography_tpu_torch.data import load_data, transfer_func_ct
    from nerf_for_angiography_tpu_torch.data.volumes import load_ct_volume
    from nerf_for_angiography_tpu_torch.utils import write_structured_points

    rng = np.random.default_rng(0)
    raw = (rng.random((40, 36, 32)) * 4200 - 100).astype(np.float32)
    write_structured_points("ct-volume.vtk", raw, origin=(-20.0, -18.0, -16.0),
                            spacing=(1.0, 1.0, 1.0), name="scalars")
    paths = datagen.main(["--volume", "ct-volume.vtk", "--out", "data_vtk", "--limited_size",
                          "90", "--number_angles", "2", "--img_size", "32"])
    vol = load_ct_volume("ct-volume.vtk", device=DEVICE)
    want = transfer_func_ct(raw)
    same = vol.values.device.type == torch.device(DEVICE).type and torch.equal(
        vol.values.cpu(), want)
    loaded = load_data(paths["proj_csv"], paths["rays_csv"], device=DEVICE)
    print(f"VTK datagen CLI: a 40x36x32 STRUCTURED_POINTS CT volume: the loaded grid's nodes "
          f"equal transfer_func_ct of the raw values {same}; {loaded.num_views} views of "
          f"{loaded.rays_per_view} rays loaded back")
    check(same and loaded.num_views == 10 and loaded.rays_per_view == 32 * 32,
          "VTK datagen: the loaded grid or the CSVs are wrong")
    return dict(nodes_equal=same, views=loaded.num_views)


def cli_phase(torch, fm, fk, fs, ev: dict, lca_ds, report: dict) -> dict:
    """The user pipeline through the port's entry points in a temporary
    workspace (cwd, restored after): --help of the four CLIs in fresh
    processes; the CT, LCA and VTK-file datagens (rays loaded from the CSVs
    equal to in-memory datasets bit for bit); the train CLI at the shipped
    defaults for 600 steps (#1, #2 and #5 launched, #3, #4 and #6
    never; its run directory written), beside an in-process train() on the
    in-memory dataset; the evaluate CLI's full 37x37 sweep on that run
    (#1 343 + 31, #5 343; every artifact read back, the per-angle JSONs
    against the sweep's images); load_experiments of the workspace."""
    import tempfile

    import numpy as np

    from nerf_for_angiography_tpu_torch.analysis import load_experiments
    from nerf_for_angiography_tpu_torch.cli import analyze, evaluate
    from nerf_for_angiography_tpu_torch.cli import train as train_cli
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )
    from nerf_for_angiography_tpu_torch.evaluation import EvalConfig
    from nerf_for_angiography_tpu_torch.training import parse_train_args, train

    out = dict(native_build_s=report["native_build"], help=cli_help(HERE))
    have = eval_artifacts_available()
    old = os.getcwd()
    os.makedirs(os.path.join(HERE, "smoke_out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "smoke_out")) as ws:
        os.chdir(ws)
        try:
            ct_cfg = DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=100,
                                   img_height=100)
            ct_ds = generate_dataset(make_vessel_volume(device=DEVICE), ct_cfg, device=DEVICE)
            out["ct_datagen"] = cli_datagen(
                torch, ["--volume", "phantom:vessel", "--limited_size", "180", "--number_angles",
                        "4", "--img_size", "100"], ct_ds, "CT", "cttoproj")
            out["lca_datagen"] = cli_datagen(
                torch, ["--data_name", "LCA", "--volume", "phantom:lca"], lca_ds, "LCA",
                "sdftoproj")
            out["vtk_datagen"] = cli_vtk_datagen(torch)

            reset_all(fm, fk, fs)
            res = train_cli.main(CLI_TRAIN_ARGV)
            torch.cuda.synchronize()
            counts = read_counts(fm, fk, fs)
            (rd,) = [os.path.join("cases", "ct", "runs", d)
                     for d in os.listdir(os.path.join("cases", "ct", "runs"))]
            written = {f: os.path.exists(os.path.join(rd, f))
                       for f in ("highmodel.npz", "coarsegrid.vtk", "readme.txt")}
            # a log_dir as the CLI's: with a logger the loop drains the tuner's
            # pressure every 100 steps (JAX loop.py:528-538), which moves its
            # schedule
            cfg, _ = parse_train_args(CLI_TRAIN_ARGV)
            same = train(cfg, ct_ds.rays, src_pt_z=float(ct_cfg.src_pt[2]), verbose=False,
                         log_dir="in_process_run", checkpoint_every=cfg.save_every,
                         device=DEVICE)
            t, ts = res.timing, same.timing
            print(f"train CLI: {res.iters_run + 1} steps at the shipped defaults; launches "
                  f"fwd {counts['fwd_launches']} bwd {counts['bwd_launches']} first_k "
                  f"{counts['first_k_launches']} fused_step {counts['fused_step_launches']} "
                  f"enc_fwd {counts['enc_fwd_launches']} enc_bwd {counts['enc_bwd_launches']}; "
                  f"wrote {', '.join(f for f, ok in written.items() if ok)} under {rd}; best "
                  f"held-out PSNR {res.best_heldout_psnr:.3f} dB, steady "
                  f"{t['steady_rays_per_sec']:.0f} rays/s (final Tuning {t['tuning_final']}); "
                  f"in-process train() on the in-memory dataset, same config, seed and a "
                  f"log_dir: {same.best_heldout_psnr:.3f} dB, {ts['steady_rays_per_sec']:.0f} "
                  f"rays/s (final Tuning {ts['tuning_final']}); best PSNR equal "
                  f"{same.best_heldout_psnr == res.best_heldout_psnr} (a record, not a gate)")
            check(counts["fwd_launches"] > 0 and counts["bwd_launches"] > 0
                  and counts["first_k_launches"] > 0 and counts["fused_step_launches"] == 0,
                  f"train CLI: launches {counts}: #1, #2 and #5 must launch, #6 never")
            check_no_enc(counts, "train CLI")
            check(all(written.values()), f"train CLI: {rd} lacks {written}")
            out["train"] = dict(**counts, run_dir=rd, steps=res.iters_run + 1,
                                best_heldout_psnr=res.best_heldout_psnr,
                                steady_rays_per_sec=t["steady_rays_per_sec"],
                                tuning_final=t["tuning_final"],
                                in_process=dict(best_heldout_psnr=same.best_heldout_psnr,
                                                steady_rays_per_sec=ts["steady_rays_per_sec"],
                                                tuning_final=ts["tuning_final"]))

            ecfg = EvalConfig(save_videos=have["PIL"], save_heatmap=have["matplotlib"])
            argv = ["--run_dir", rd] + ([] if have["PIL"] else ["--no_videos"]) + (
                [] if have["matplotlib"] else ["--no_heatmap_png"])
            n_views, n_angle_jsons = CLI_SWEEP
            batches = math.ceil(n_views / ecfg.chunk_views)
            want = dict(fwd_launches=batches + math.ceil(ecfg.field_resolution ** 3 / EVAL_CHUNK),
                        first_k_launches=batches, bwd_launches=0, fused_step_launches=0,
                        enc_fwd_launches=0, enc_bwd_launches=0)
            reset_all(fm, fk, fs)
            t0 = time.perf_counter()
            with recorded_field() as fields:
                tables = evaluate.main(argv)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            counts = read_counts(fm, fk, fs)
            table = tables[rd]
            print(f"evaluate CLI: the {n_views}-view sweep of {rd} in {eval_s:.2f} s; launches "
                  f"fwd {counts['fwd_launches']} (expected {want['fwd_launches']}) first_k "
                  f"{counts['first_k_launches']} (expected {want['first_k_launches']}) bwd "
                  f"{counts['bwd_launches']} fused_step {counts['fused_step_launches']} enc_fwd "
                  f"{counts['enc_fwd_launches']} enc_bwd {counts['enc_bwd_launches']}")
            check(counts == want, f"evaluate CLI: launches {counts} != {want}")
            heat = [c for c in table if c in ("PSNR", "SSIM", "DICE 2D", "DOT 2D", "LPIPS",
                                              "DISTS")]
            arts = check_sweep_artifacts(torch, "evaluate CLI", table, rd, ecfg, fields[0],
                                         CLI_COLUMNS, heat, evaluate.read_page_data(rd), False)
            check(arts["csv_rows"] == n_views and arts["angle_jsons"] == n_angle_jsons,
                  f"evaluate CLI: {arts['csv_rows']} metric rows and {arts['angle_jsons']} "
                  f"per-angle JSONs, not {n_views} and {n_angle_jsons}")
            out["evaluate"] = dict(**counts, expected=want, eval_s=eval_s, artifacts=arts,
                                   psnr_mean=float(np.mean(table["PSNR"])))

            exps = load_experiments("cases")
            cols = [c for c in exps if c.endswith((" mean", " min"))]
            print(f"analysis: load_experiments('cases') reads {len(exps['run'])} run(s) with "
                  f"{len(cols)} metric columns; PSNR mean {exps['PSNR mean'][0]:.4f}")
            check(exps["run"] == [os.path.basename(rd)]
                  and {f"{m} {q}" for m in ("PSNR", "SSIM", "DICE 2D", "LPIPS", "DISTS")
                       for q in ("mean", "min")} <= set(cols),
                  "load_experiments did not read the evaluated run back")
            if have["matplotlib"]:
                analyze.main(["--out", "plot.png"])
                check(os.path.getsize("plot.png") > 0, "analyze: no plot written")
            else:
                print("analyze: the plot is not drawn: the card has no matplotlib "
                      "(load_experiments read the run)")
            out["analysis"] = dict(runs=len(exps["run"]), columns=cols)
        finally:
            os.chdir(old)
    json_s = {k: ev[k]["seconds_by_part"].get("json") for k in ("ct", "lca")}
    print(f"sweep JSONs through the native writer (eval phase, run_sweep timing): CT "
          f"{json_s['ct']:.2f} s, LCA {json_s['lca']:.2f} s")
    out["eval_json_s"] = json_s
    report["cli"] = out
    return out


# ---------------------------------------------------------------------------
# pose refinement (pose_phase) and the classic coarse-to-fine path
# (classic_phase)
# ---------------------------------------------------------------------------

# the shipped pose run: TrainConfig() with pose_refine, the shifts learned
# from step POSE_START on, on the phantom's views shifted by up to
# POSE_SHIFT of its largest |coordinate| and rays from the nominal cameras
POSE_ITERS, POSE_START, POSE_SHIFT = 600, 200, 0.05
POSE_STEP = 601  # the compacted / fourier pose steps' step: no grid update (601 % 16)
POSE_REPLAY_STEPS = 40  # replayed against eager pose steps, across the grid update at 608
# the JAX recovery test's setup (tests/test_training.py:352-425): a vessel of
# res 48, 24x24 views, 576-ray batches, 900 steps from a fresh state, the
# shifts learned from step 200, its thresholds on the in-plane residuals.
# One run meets them or not by its draws (the JAX package meets both on
# RECOVERY_JAX_MET of its keys 0-7, tools/jax_pose_recovery_seeds.py), so
# the card holds them to the residuals averaged over RECOVERY_SEEDS runs,
# seeds 0 to 7, and at least as many seeds as JAX's to meet both alone
RECOVERY_ITERS, RECOVERY_MEAN, RECOVERY_VIEW, RECOVERY_SEEDS = 900, 0.4, (0.8, 0.05), 8
RECOVERY_JAX_MET = 6
# that test's translations (mm, view by view, the test view last): its
# datagen's draws from PRNGKey(5), recorded here (the card has no JAX) and
# put in place of the port's draw (data/datasets.py::pose_shifts)
RECOVERY_SHIFTS = ((3.4225661754608154, 1.93932044506073, -2.1914472579956055),
                   (-3.021977424621582, 1.4659167528152466, -0.8585572838783264),
                   (-0.8368690013885498, -0.33050182461738586, 0.25691184401512146),
                   (-0.48897212743759155, 2.492156982421875, -3.2596986293792725),
                   (0.0, 0.0, 0.0))
CLI_POSE_ARGV = ["--pose_refine", "--n_iters", "300", "--display_every", "100"]
# the classic path at full width: TrainConfig()'s 4x128 CPPN and lr, 75^2
# rays, 300 coarse + 64 fine samples a ray. The field first sheds its
# initial opacity (about 120 steps) and then learns the vessels: the last
# CLASSIC_WINDOW steps' mean fine loss must be below CLASSIC_LEARNED of an
# empty field's (read 0.61 at 300 steps and 0.20 at 1,500; a field that
# learned only the transparent background reads 0.95-0.98: at the JAX
# classic tests' lr 5e-3, and at 1e-3, this width collapses to that,
# chip_smoke.py --classic-probe)
CLASSIC_ITERS, CLASSIC_FINE, CLASSIC_VIEWS_ITERS = 400, 64, 40
CLASSIC_WINDOW, CLASSIC_LEARNED = 20, 0.8
CLASSIC_PROBE_LRS = (5e-3, 1e-3, 1e-4)  # the JAX classic tests', a middle one, TrainConfig()'s


def make_pose_dataset(torch):
    """The smoke's vessel phantom (make_dataset: 26 views of 100x100) with a
    random translation of up to POSE_SHIFT of the phantom's largest
    |coordinate| on every view but the test view, the rays from the nominal
    cameras (the mis-calibration pose refinement must undo); the shifts
    drawn from a generator seeded with 0."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )

    cfg = DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=100, img_height=100,
                        sample_outside=100.0, stratified_depths=False,
                        max_shift_translation=POSE_SHIFT, rays_from_nominal=True)
    t0 = time.perf_counter()
    ds = generate_dataset(make_vessel_volume(res=96), cfg,
                          generator=torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    tr = [ds.proj[f"translation_{c}"] for c in "xyz"]
    print(f"pose datagen: {ds.rays.num_rays} rays, {ds.images.shape[0]} views, max |translation| "
          f"{max(max(abs(v) for v in col) for col in tr):.3f}, "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, ds


@contextlib.contextmanager
def recorded_shifts(at: int):
    """Within the block, the view shifts of train()'s chunks just before and
    just after the step that starts with ``state.step == at`` (the first
    step whose pose lr is not 0), copied on the device in stream order."""
    graph = importlib.import_module("nerf_for_angiography_tpu_torch.training.graph")
    step = graph.TrainChunk.step
    seen: dict = {}

    def recording(self, state, rays):
        if state.step != at:
            return step(self, state, rays)
        seen["before"] = state.model.view_shifts.detach().clone()
        out = step(self, state, rays)
        seen["after"] = state.model.view_shifts.detach().clone()
        return out

    graph.TrainChunk.step = recording
    try:
        yield seen
    finally:
        graph.TrainChunk.step = step


@contextlib.contextmanager
def mlp_dispatch(fm, fe, plain: bool, record: list):
    """Within the block the MLP backward wrappers append what a step hands
    them ((packed, x, g), and for the encoded pair (packed, a, w, x, g)) to
    ``record``; with ``plain`` the fused-MLP pairs and first-k dispatch to
    their plain versions on the card (a yardstick, outside every counted
    run)."""
    occ = importlib.import_module("nerf_for_angiography_tpu_torch.ops.occupancy")
    fk = importlib.import_module("nerf_for_angiography_tpu_torch.ops.kernels.first_k")
    saved = {(fm, "fused_mlp_fwd"): fm.fused_mlp_fwd, (fm, "fused_mlp_bwd"): fm.fused_mlp_bwd,
             (fe, "fused_mlp_enc_fwd"): fe.fused_mlp_enc_fwd,
             (fe, "fused_mlp_enc_bwd"): fe.fused_mlp_enc_bwd,
             (occ, "first_k_active"): occ.first_k_active}
    bwd, enc_bwd = saved[(fm, "fused_mlp_bwd")], saved[(fe, "fused_mlp_enc_bwd")]
    if plain:
        bwd, enc_bwd = fm.fused_mlp_bwd_reference, fe.fused_mlp_enc_bwd_reference
        fm.fused_mlp_fwd = fm.fused_mlp_fwd_reference
        fe.fused_mlp_enc_fwd = fe.fused_mlp_enc_fwd_reference
        occ.first_k_active = fk.first_k_active_reference

    def recording_bwd(packed, x, g, feature_major=False):
        record.append((packed, x, g))
        return bwd(packed, x, g, feature_major)

    def recording_enc_bwd(packed, a, w, x, g):
        record.append((packed, a, w, x, g))
        return enc_bwd(packed, a, w, x, g)

    fm.fused_mlp_bwd, fe.fused_mlp_enc_bwd = recording_bwd, recording_enc_bwd
    try:
        yield record
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def pose_state_from(torch, src, cfg, shifts):
    """A pose state of ``cfg`` holding the weights of the state ``src``,
    the view shifts ``shifts`` and clones of its grids, at POSE_STEP."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import OccupancyGrid
    from nerf_for_angiography_tpu_torch.training import create_train_state

    model, state = create_train_state(cfg, num_views=shifts.shape[0], device=DEVICE)
    sd = {k: v for k, v in src.model.state_dict().items() if k != "view_shifts"}
    model.load_state_dict({**sd, "view_shifts": shifts})
    state.grid, state.vessel_grid = (
        OccupancyGrid(*(None if t is None else t.clone() for t in g))
        for g in (src.grid, src.vessel_grid))
    state.step = POSE_STEP
    return state


def pose_step_check(torch, fm, fk, fs, fe, state, cfg, batch, label: str) -> dict:
    """One eager pose step (step_core on ``batch``) from two copies of
    ``state``: through the kernels (launch counts read around it) and
    through their plain versions on the card. The view shifts' gradients
    of the two, normalised by the plain one's max, within GRAD_NORM_MAX; the
    MLP backward kernel's dx (#2, or #4 for an encoded model) against its
    plain version at the x and g the kernel step handed it (check_bwd's
    limits: DX_BAD_SHARE(_ENC) and relu ties) and its time beside the bound
    over the active tiles (trained_row)."""
    from nerf_for_angiography_tpu_torch.training import copy_state, make_train_step

    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    grads, recs = {}, {}
    for plain in (False, True):
        st = copy_state(state)
        step = make_train_step(st.model, cfg, near, far)
        rec: list = []
        reset_all(fm, fk, fs)
        with mlp_dispatch(fm, fe, plain, rec):
            step.step_core(st, batch)
        torch.cuda.synchronize()
        if not plain:
            counts = read_counts(fm, fk, fs)
        grads[plain], recs[plain] = st.model.view_shifts.grad.detach().clone(), rec
    gk, gp = grads[False], grads[True]
    err = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
    check(float(gp.abs().max()) > 0, f"{label}: the view shifts' gradient is 0")
    check(err <= GRAD_NORM_MAX, f"{label}: view_shifts.grad of the kernels differs from the "
                                f"plain versions' by {err:.3e} normalised")
    (args,) = recs[False]
    enc = None
    if len(args) == 5:
        packed, a, w, x, g = args
        enc = (fe, a, w)
    else:
        packed, x, g = args
    pbytes = sum(t.numel() * t.element_size() for t in packed)
    r = trained_row(torch, fm, packed, pbytes, x, g, f"the pose step, {label}", enc=enc)
    out = dict(label=label, **counts, view_shifts_grad_norm_err=err,
               view_shifts_grad_max=float(gp.abs().max()), **r)
    print(f"pose step, {label}: launches {counts}; view_shifts.grad kernels against plain "
          f"{err:.3e} normalised (limit {GRAD_NORM_MAX}); the backward's g active on "
          f"{out['active_tile_share']:.4f} of the 16-point tiles; dx beyond the limit on "
          f"{r['dx_bad_share']:.2e} of the points, relative L2 {r['dx_rel_l2']:.3e}")
    return out


@contextlib.contextmanager
def injected_shifts(translations):
    """Within the block the port's datagen takes ``translations`` (V, 3) as
    its pose shifts (no rotation) in place of its own draw."""
    import numpy as np

    dst = importlib.import_module("nerf_for_angiography_tpu_torch.data.datasets")
    draw = dst.pose_shifts
    tr = np.asarray(translations, np.float32)
    dst.pose_shifts = lambda config, n_views, generator, grid_dim: (np.zeros_like(tr), tr)
    try:
        yield
    finally:
        dst.pose_shifts = draw


def pose_recovery(torch, fm, fk, fs, fe) -> dict:
    """The JAX slow test test_pose_refinement_recovers_translation on the
    card: the port's datagen at that test's sizes with that test's
    translations (RECOVERY_SHIFTS), 900 steps of a fresh pose state through
    make_train_chunk (replayed graphs) for each of RECOVERY_SEEDS seeds, the
    learned shifts' in-plane residuals after the best global gauge
    translation against the uncorrected ones. Each seed's are printed; the
    JAX test's two thresholds are held on their mean over the seeds, and
    the number of seeds meeting both alone to at least the JAX package's
    own (RECOVERY_JAX_MET). Each seed that fails alone is run again, not
    held to anything, three ways: eager steps through the kernels' plain
    versions, and its initial weights moved one ulp up and one ulp down (a
    failure the kernels cause follows the kernels; one the draws cause
    moves with any rounding)."""
    import numpy as np

    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_chunk, make_train_step,
    )

    w = h = 24
    with injected_shifts(RECOVERY_SHIFTS):
        ds = generate_dataset(
            make_vessel_volume(res=48),
            DatagenConfig(limited_size=90.0, number_angles=1.0, img_width=w, img_height=h,
                          sample_outside=100.0, stratified_depths=False,
                          max_shift_translation=POSE_SHIFT, rays_from_nominal=True),
            device=DEVICE)
    gt = np.stack([np.asarray(ds.proj[f"translation_{c}"], np.float64) for c in "xyz"], -1)
    n_views = gt.shape[0]
    check(np.abs(gt[:-1]).max() > 1.0, "recovery: the shifts were not injected")
    dirs = ds.rays.directions.cpu().numpy().reshape(n_views, w * h, 3)
    d_c = dirs[:, (h // 2) * w + w // 2]
    d_c = d_c / np.linalg.norm(d_c, axis=-1, keepdims=True)
    proj = np.eye(3)[None] - d_c[:, :, None] * d_c[:, None, :]

    def inplane(learned):
        r = learned - gt
        rhs = np.einsum("vij,vj->vi", proj, r)
        gauge, *_ = np.linalg.lstsq(proj.reshape(-1, 3), rhs.reshape(-1), rcond=None)
        return np.linalg.norm(np.einsum("vij,vj->vi", proj, r - gauge[None]), axis=-1)

    e0 = inplane(np.zeros_like(gt))

    def run(seed: int, how: str = "kernels") -> dict:
        """900 steps from seed ``seed``: through the kernels in replayed
        graphs, ``plain`` eager through the plain versions, or ``ulp +1`` /
        ``ulp -1`` with every initial weight moved one ulp."""
        cfg = TrainConfig(depth_samples_per_ray=32, sample_size=24, grid_resolution=8,
                          display_every=50, n_iters=RECOVERY_ITERS, early_stop_iters=10_000,
                          coarse_lr=2e-3, pose_refine=True, pose_lr=3e-2,
                          pose_start=POSE_START, grid_update_every=100_000, seed=seed)
        model, state = create_train_state(cfg, num_views=n_views, device=DEVICE)
        if how.startswith("ulp"):
            to = math.inf if how == "ulp +1" else -math.inf
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name != "view_shifts":
                        p.copy_(torch.nextafter(p, torch.full_like(p, to)))
        reset_all(fm, fk, fs)
        t0 = time.perf_counter()
        if how == "plain":
            step, rec = make_train_step(model, cfg, 1400.0, 1600.0), []
            with mlp_dispatch(fm, fe, True, rec):
                for _ in range(RECOVERY_ITERS):
                    _, metrics, _, _ = step(state, ds.rays)
                    rec.clear()
            graphs = 0
        else:
            chunk = make_train_chunk(model, cfg, 1400.0, 1600.0, RECOVERY_ITERS)
            _, metrics, _, _ = chunk(state, ds.rays)
            graphs = chunk.captures
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(fm, fk, fs)
        e = inplane(model.view_shifts.detach().cpu().numpy().astype(np.float64))
        r = dict(seed=seed, how=how, wall_s=wall, graphs=graphs, **counts, e=e.tolist(),
                 mean_ratio=float(e.mean() / e0.mean()),
                 views_ok=bool((e < RECOVERY_VIEW[0] * e0 + RECOVERY_VIEW[1]).all()),
                 loss=float(metrics["loss/train-pixel-coarse"]))
        r["meets_both"] = r["mean_ratio"] < RECOVERY_MEAN and r["views_ok"]
        print(f"pose recovery seed {seed} ({how}): {RECOVERY_ITERS} steps in {wall:.2f} s "
              f"({graphs} graphs), launches fwd {counts['fwd_launches']} bwd "
              f"{counts['bwd_launches']}; in-plane residual mean ratio {r['mean_ratio']:.4f} "
              f"(the JAX test's limit {RECOVERY_MEAN}), every view below "
              f"{RECOVERY_VIEW[0]} e0 + {RECOVERY_VIEW[1]}: {r['views_ok']}; loss {r['loss']:.3e}")
        check(math.isfinite(r["loss"]), f"recovery seed {seed} ({how}): the loss is not finite")
        want_bwd = 0 if how == "plain" else RECOVERY_ITERS
        check((counts["fwd_launches"] > 0) == (how != "plain")
              and counts["bwd_launches"] == want_bwd,
              f"recovery seed {seed} ({how}): launches {counts}")
        return r

    runs = [run(seed) for seed in range(RECOVERY_SEEDS)]
    totals = {k: sum(r[k] for r in runs) for k in read_counts(fm, fk, fs)}
    e = np.mean([r["e"] for r in runs], axis=0)
    met = sum(r["meets_both"] for r in runs)
    reruns = [run(r["seed"], how) for r in runs if not r["meets_both"]
              for how in ("plain", "ulp +1", "ulp -1")]
    out = dict(**totals, e0=e0.tolist(), e_mean=e.tolist(),
               mean_ratio=float(e.mean() / e0.mean()), seeds_meeting_both=met, runs=runs,
               reruns=reruns)
    print(f"pose recovery over seeds 0-{RECOVERY_SEEDS - 1}: mean in-plane residual "
          f"{np.round(e, 4).tolist()} against {np.round(e0, 4).tolist()} uncorrected (ratio "
          f"{out['mean_ratio']:.4f}, limit {RECOVERY_MEAN}); {met} of {RECOVERY_SEEDS} seeds "
          f"meet both of the JAX test's thresholds alone (the JAX package: "
          f"{RECOVERY_JAX_MET}); the failing seeds run again: "
          + ", ".join(f"seed {r['seed']} {r['how']} {r['mean_ratio']:.4f} "
                      f"(both met {r['meets_both']})" for r in reruns))
    check(e.mean() < RECOVERY_MEAN * e0.mean(),
          f"recovery: the seeds' mean in-plane residual {e.mean():.4f} is not below "
          f"{RECOVERY_MEAN} x {e0.mean():.4f}")
    check(bool((e < RECOVERY_VIEW[0] * e0 + RECOVERY_VIEW[1]).all()),
          f"recovery: a view's mean residual is not below {RECOVERY_VIEW[0]} e0 + "
          f"{RECOVERY_VIEW[1]}: {e} against {e0}")
    check(met >= RECOVERY_JAX_MET,
          f"recovery: {met} of {RECOVERY_SEEDS} seeds meet both thresholds alone, fewer than "
          f"the JAX package's {RECOVERY_JAX_MET}")
    return out


def pose_cli(torch, fm, fk, fs, dcfg, ds) -> dict:
    """The train CLI with --pose_refine on the CSVs the port writes of the
    pose-shift dataset (read back by load_data equal to it), in a
    temporary workspace: #1 and #2 launched, #6 never, the shifts moved and
    stored in the run's highmodel.npz."""
    import tempfile

    from nerf_for_angiography_tpu_torch.cli import train as train_cli
    from nerf_for_angiography_tpu_torch.cli.datagen import csv_file_names
    from nerf_for_angiography_tpu_torch.data import load_data, write_proj_csv, write_rays_csv
    from nerf_for_angiography_tpu_torch.training import load_model

    old = os.getcwd()
    os.makedirs(os.path.join(HERE, "smoke_out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "smoke_out")) as ws:
        os.chdir(ws)
        try:
            os.makedirs(os.path.join("data", "ct"))
            proj, rays = (os.path.join("data", "ct", n) for n in csv_file_names(dcfg, False))
            write_proj_csv(ds, proj)
            write_rays_csv(ds, rays)
            check_rays_equal(torch, load_data(proj, rays, device=DEVICE), ds, "pose CSVs")
            reset_all(fm, fk, fs)
            res = train_cli.main(CLI_POSE_ARGV)
            torch.cuda.synchronize()
            counts = read_counts(fm, fk, fs)
            (rd,) = [os.path.join("cases", "ct", "runs", d)
                     for d in os.listdir(os.path.join("cases", "ct", "runs"))]
            _, params = load_model(os.path.join(rd, "highmodel.npz"))
        finally:
            os.chdir(old)
    shifts = res.state.model.view_shifts.detach()
    out = dict(**counts, steps=res.iters_run + 1, best_heldout_psnr=res.best_heldout_psnr,
               steady_rays_per_sec=res.timing["steady_rays_per_sec"],
               max_shift=float(shifts.abs().max()),
               bundle_view_shifts=list(params["params"]["view_shifts"].shape))
    print(f"train CLI {' '.join(CLI_POSE_ARGV)}: {out['steps']} steps, launches {counts}, "
          f"best held-out PSNR {res.best_heldout_psnr:.3f} dB, steady "
          f"{out['steady_rays_per_sec']:.0f} rays/s, max |view shift| {out['max_shift']:.4f}, "
          f"highmodel.npz view_shifts {out['bundle_view_shifts']}")
    check(counts["fwd_launches"] > 0 and counts["bwd_launches"] == out["steps"]
          and counts["fused_step_launches"] == 0, f"pose train CLI: launches {counts}")
    check_no_enc(counts, "pose train CLI")
    check(out["max_shift"] > 0 and out["bundle_view_shifts"] == list(shifts.shape),
          "pose train CLI: the shifts did not move or are missing from the bundle")
    return out


def pose_phase(torch, fm, fk, fs, fe, cp: dict, ep: dict, report: dict) -> dict:
    """Pose refinement on the card: the shipped TrainConfig() with
    pose_refine and pose_start POSE_START on the pose-shift phantom, 600
    steps through train() (#1 launched, #2 on every step, #6 never; the
    shifts exactly 0 before step POSE_START and moved by it; best held-out
    PSNR and steady rays/s beside the shipped split run's); pose steps of
    the trained pose model on the shipped run's trained grid at the lattice
    and two-bucket Tunings and, with the fourier run's weights, one fourier
    lattice step (pose_step_check: #5 (and #3/#4) launched, the view shifts'
    gradient and the backward kernel's dx against the plain versions);
    POSE_REPLAY_STEPS replayed lattice pose steps against eager ones bit for
    bit; the JAX recovery test (pose_recovery); the train CLI with
    --pose_refine (pose_cli)."""
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, copy_state, drop_test_view, make_train_chunk, make_train_step,
    )

    dcfg, ds = make_pose_dataset(torch)
    cfg = TrainConfig(n_iters=POSE_ITERS, pose_refine=True, pose_start=POSE_START)
    with recorded_shifts(POSE_START) as seen:
        run = compacted_run(torch, fm, fk, fs, ds, cfg, "pose shipped")
    res = run.pop("result")
    steps = run["steps"]
    check(run["fwd_launches"] > 0 and run["bwd_launches"] == steps
          and run["fused_step_launches"] == 0,
          f"pose shipped: launches fwd {run['fwd_launches']} bwd {run['bwd_launches']} "
          f"fused_step {run['fused_step_launches']}: #1 > 0, #2 every step and #6 never")
    before, after = seen["before"], seen["after"]
    shifts = res.state.model.view_shifts.detach()
    run.update(shifts_zero_before_pose_start=bool((before == 0).all()),
               shifts_max_after_pose_start=float(after.abs().max()),
               shifts_max_final=float(shifts.abs().max()))
    shipped = cp["shipped"]

    def rates(r):
        dense = r["dense_rays"] / r["step_dense_s"] if r["step_dense_s"] > 0 else 0.0
        return (f"steady compacted {r['steady_rays_per_sec']:.0f}, dense {dense:.0f}, end to "
                f"end {r['rays_per_s_incl_first']:.0f} rays/s")

    print(f"pose shipped: view shifts all 0 after step {POSE_START - 1} "
          f"{run['shifts_zero_before_pose_start']}, max |shift| after step {POSE_START} "
          f"{run['shifts_max_after_pose_start']:.3e}, final {run['shifts_max_final']:.4f}; "
          f"best held-out PSNR {run['best_heldout_psnr']:.3f} dB, {rates(run)}; the shipped "
          f"split run: {shipped['best_heldout_psnr']:.3f} dB, {rates(shipped)} (another "
          f"dataset: the views shifted, the rays nominal; no carve under pose_refine)")
    check(run["shifts_zero_before_pose_start"],
          f"pose shipped: the shifts moved before step {POSE_START}")
    check(run["shifts_max_after_pose_start"] > 0,
          f"pose shipped: the shifts did not move at step {POSE_START}")

    n_views = shifts.shape[0]
    rpv = ds.rays.num_rays // n_views
    train_rays = drop_test_view(ds.rays, n_views - 1, rpv)
    batch = sample_pixel_rays(torch.Generator(device=DEVICE).manual_seed(3), train_rays,
                              cfg.img_sample_size, impl="gumbel")
    grid_src = cp["shipped"]["result"].state
    base = copy_state(res.state)
    base.grid, base.vessel_grid = grid_src.grid, grid_src.vessel_grid
    steps_out = {}
    for name, tun in (("lattice k=160", LATTICE), ("two-bucket", TWO_BUCKET)):
        st = pose_state_from(torch, base, cfg, shifts)
        steps_out[name] = pose_step_check(torch, fm, fk, fs, fe, st, tuning_cfg(cfg, tun), batch,
                                          name)
        want_fk = 1 if tun is LATTICE else 2
        c = steps_out[name]
        check(c["first_k_launches"] == want_fk and c["bwd_launches"] == 1
              and c["fwd_launches"] >= 1 and c["fused_step_launches"] == 0,
              f"pose step, {name}: launches {c}")
    fcfg = TrainConfig(pos_enc="fourier", pose_refine=True, pose_start=POSE_START)
    st = pose_state_from(torch, ep["states"]["fourier"], fcfg, shifts)
    name = "fourier lattice k=160"
    steps_out[name] = pose_step_check(torch, fm, fk, fs, fe, st, tuning_cfg(fcfg, LATTICE),
                                      batch, name)
    c = steps_out[name]
    check(c["enc_fwd_launches"] >= 1 and c["enc_bwd_launches"] == 1
          and c["first_k_launches"] == 1 and c["fwd_launches"] == 0 and c["bwd_launches"] == 0,
          f"pose step, {name}: launches {c}")

    # the replayed pose step against the eager one, across the grid update at 608
    lcfg = tuning_cfg(cfg, LATTICE)
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    src = pose_state_from(torch, base, cfg, shifts)
    ways = {}
    for way in ("graph", "eager"):
        st = copy_state(src)
        reset_all(fm, fk, fs)
        if way == "graph":
            chunk = make_train_chunk(st.model, lcfg, near, far, POSE_REPLAY_STEPS)
            _, metrics, pix, _ = chunk(st, train_rays)
        else:
            step = make_train_step(st.model, lcfg, near, far)
            for _ in range(POSE_REPLAY_STEPS):
                _, metrics, pix, _ = step(st, train_rays)
        torch.cuda.synchronize()
        ways[way] = dict(state=st, metrics=metrics, pix=pix, counts=read_counts(fm, fk, fs))
    g, e = ways["graph"], ways["eager"]
    got, want = state_tensors_of(g["state"]), state_tensors_of(e["state"])
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    unequal += [f"metric {k}" for k in e["metrics"]
                if not torch.equal(g["metrics"][k], e["metrics"][k])]
    if not torch.equal(g["pix"], e["pix"]):
        unequal.append("pixels")
    replay = dict(steps=POSE_REPLAY_STEPS, graphs=chunk.captures, counts=g["counts"],
                  unequal=unequal, tensors=len(want))
    print(f"pose replay: {POSE_REPLAY_STEPS} lattice pose steps from step {POSE_STEP}, "
          f"{chunk.captures} graphs; {len(want)} state tensors (both AdamW groups among them), "
          f"the metrics and pixels equal to the eager steps' bit for bit: {not unequal}; "
          f"launches {g['counts']} (eager {e['counts']})")
    check(not unequal, f"pose replay: replayed and eager steps differ in {unequal}")
    check(g["counts"] == e["counts"] and chunk.captures >= 1 and g["counts"]["first_k_launches"]
          == POSE_REPLAY_STEPS, f"pose replay: launches {g['counts']} / {e['counts']}")

    # where a replayed pose step's time goes (the graph phase profiles the
    # split steps at these Tunings in the same call)
    profiles = {}
    for name, pcfg in (("dense", dataclasses.replace(cfg, compact_samples=0)),
                       ("lattice k=160", lcfg)):
        print(f"pose step profile, {name}:")
        profiles[name] = step_profile(torch, copy_state(src), train_rays, pcfg, graph=True)
    recovery = pose_recovery(torch, fm, fk, fs, fe)
    cli = pose_cli(torch, fm, fk, fs, dcfg, ds)
    out = dict(shipped=run, steps=steps_out, replay=replay, profiles=profiles,
               recovery=recovery, cli=cli)
    report["pose"] = out
    return out


def classic_run(torch, fm, fk, fs, ds, cfg, label: str, iters: int, separate: bool) -> dict:
    """``iters`` classic steps (make_classic_train_step, eager) of a fresh
    model, with a separate fine model when ``separate``, on every view of
    ``ds`` as the JAX test feeds it; all six launch counters 0 around the
    run (the classic path runs the module's own forward, as JAX runs
    model.apply), the fine loss's first and last values, seconds a step."""
    from nerf_for_angiography_tpu_torch.models import CPPN
    from nerf_for_angiography_tpu_torch.training import (
        create_classic_state, create_train_state, make_classic_train_step,
    )

    model, _ = create_train_state(cfg, device=DEVICE)
    fine = (CPPN(cfg.model_config(), generator=torch.Generator().manual_seed(7)).to(DEVICE)
            if separate else None)
    state = create_classic_state(model, cfg, fine_model=fine, device=DEVICE)
    near, far = SRC_Z - cfg.outside, SRC_Z + cfg.outside
    step = make_classic_train_step(model, cfg, near, far, n_fine=CLASSIC_FINE, fine_model=fine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(fm, fk, fs)
    metrics = []
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, ds.rays)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(fm, fk, fs)
    fine_losses = [float(m["loss/train-pixel-fine"]) for m in metrics]
    # an all-transparent field renders every pixel 1: its loss on batches
    # drawn by the sampling weights
    px, w = ds.rays.pixel_values, ds.rays.weights
    empty = float(((1.0 - px) ** 2 * w).sum() / w.sum())
    # the fine loss of each CLASSIC_WINDOW steps, averaged (one batch's is
    # noisy), over the empty field's
    windows = [statistics.fmean(fine_losses[i:i + CLASSIC_WINDOW]) / empty
               for i in range(0, iters - CLASSIC_WINDOW + 1, CLASSIC_WINDOW)]
    out = dict(label=label, steps=iters, **counts, s_per_step=wall / iters,
               empty_field_loss=empty, window_over_empty=windows,
               loss_fine_first=fine_losses[0], loss_fine_last=fine_losses[-1],
               loss_coarse_last=float(metrics[-1]["loss/train-pixel-coarse"]),
               barf_alphas=[float(metrics[i]["barf-coarse"]) for i in (0, -1)],
               barf_views_alphas=[float(metrics[i]["barf-views-coarse"]) for i in (0, -1)],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"classic {label}: {iters} steps of {cfg.img_sample_size} rays x "
          f"{cfg.depth_samples_per_ray} + {CLASSIC_FINE} samples, {out['s_per_step'] * 1e3:.2f} "
          f"ms/step, peak {out['peak_gib']:.2f} GiB; fine loss {fine_losses[0]:.6f} -> "
          f"{fine_losses[-1]:.6f} (an empty field's: {empty:.6f}); the mean fine loss of "
          f"each {CLASSIC_WINDOW} steps over the empty field's "
          f"{[round(v, 4) for v in windows]}; launches {counts}")
    check(all(v == 0 for v in counts.values()), f"classic {label}: a kernel launched: {counts}")
    check(all(math.isfinite(v) for v in fine_losses), f"classic {label}: a loss is not finite")
    return out


def classic_phase(torch, fm, fk, fs, ds, report: dict) -> dict:
    """The classic coarse-to-fine path at full width on the phantom, at
    TrainConfig()'s lr: CLASSIC_ITERS steps with a shared and then a
    separate fine model (the fine loss halves, as the JAX test asserts, and
    its last window is below CLASSIC_LEARNED of an empty field's: the
    vessels, not only the background), then CLASSIC_VIEWS_ITERS steps of
    the view branch with BARF (barf_stop 30): both alphas reach their
    basis."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig

    out = {}
    for name, separate in (("shared", False), ("separate fine", True)):
        r = classic_run(torch, fm, fk, fs, ds, TrainConfig(), name, CLASSIC_ITERS, separate)
        check(r["loss_fine_last"] < 0.5 * r["loss_fine_first"],
              f"classic {name}: the fine loss {r['loss_fine_first']} -> {r['loss_fine_last']} "
              "did not halve")
        check(r["window_over_empty"][-1] < CLASSIC_LEARNED,
              f"classic {name}: the last {CLASSIC_WINDOW} steps' fine loss is "
              f"{r['window_over_empty'][-1]:.4f} of an empty field's, not below "
              f"{CLASSIC_LEARNED}: the field learned no more than the background")
        out[name] = r
    vcfg = TrainConfig(num_input_channels_views=3, pos_enc="barf", pos_enc_basis=4, barf_start=0,
                       barf_stop=30)
    r = classic_run(torch, fm, fk, fs, ds, vcfg, "views + BARF", CLASSIC_VIEWS_ITERS, False)
    check(r["barf_alphas"][0] < 1.0 and r["barf_alphas"][-1] == vcfg.pos_enc_basis
          and r["barf_views_alphas"][0] < 1.0
          and r["barf_views_alphas"][-1] == vcfg.pos_enc_basis_views,
          f"classic views + BARF: the alphas {r['barf_alphas']} / {r['barf_views_alphas']} did "
          "not anneal to their basis")
    out["views + BARF"] = r
    report["classic"] = out
    return out


def classic_probe(torch, fm, fk, fs, ds, iters: int, report: dict) -> None:
    """The classic path with a shared fine model for ``iters`` steps at
    each of CLASSIC_PROBE_LRS (classic_run's windows of the fine loss over
    an empty field's): how far, and at which lr, it learns more than the
    transparent background."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig

    report["classic_probe"] = {
        lr: classic_run(torch, fm, fk, fs, ds, TrainConfig(coarse_lr=lr), f"probe lr {lr}",
                        iters, False)
        for lr in CLASSIC_PROBE_LRS}


def eval_rows(ev: dict, by_path: dict) -> list[dict]:
    """The kernels line's rows for the sweeps' shapes: kernel #1 at the CT
    and LCA batches and the field chunks (random weights; the loaded
    weights' readings under ``loaded_weights``), first-k at the CT batch;
    ``launches`` the two sweeps' and the evaluate CLI's (``launches_by_path``
    per sweep)."""
    src = "nerf_for_angiography_tpu_torch/csrc/"
    paths = ("eval_ct", "eval_lca", "cli_evaluate")
    rows = []
    for label in ("ct", "lca"):
        fwd = ev[f"{label}_kernels"]["fwd"]
        for rnd, loaded in zip(fwd[0::2], fwd[1::2]):
            if label == "lca" and "field" in rnd["label"]:
                continue  # the same field chunks as the CT sweep's
            rows.append(dict(
                name="fused_mlp_fwd", route="cuda", source=src + "mlp_wgmma.cuh",
                replaces="nerf_for_angiography_tpu/ops/pallas/fused_mlp.py:142",
                launches=sum(by_path["fused_mlp_fwd"][p] for p in paths),
                launches_by_path={p: by_path["fused_mlp_fwd"][p] for p in paths},
                max_abs_err=rnd["max_abs_err"], ms=rnd["ms"], plain_ms=rnd["plain_ms"],
                bound_ms=rnd["bound_ms"], bound_by=rnd["bound_by"], library_ms=None,
                path=rnd["label"], P=rnd["P"], ms_back_to_back=rnd["ms_back_to_back"],
                loaded_weights={k: loaded[k] for k in ("max_abs_err", "median_abs_err", "ms",
                                                       "plain_ms", "bound_ms")}))
    for r in ev["ct_kernels"]["first_k"]:
        rows.append(dict(
            name="first_k_active", route="cuda", source=src + "first_k.cu",
            replaces="nerf_for_angiography_tpu/ops/pallas/first_k.py:50",
            launches=sum(by_path["first_k_active"][p] for p in paths),
            launches_by_path={p: by_path["first_k_active"][p] for p in paths},
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            path="ct sweep batch", shape=[r["R"], r["w"], r["k"]]))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--determinism", action="store_true",
                    help="also run the dense phase twice with and without deterministic "
                         "algorithms and report the ops that warn")
    ap.add_argument("--protocol", type=int, default=0,
                    help="also run one shipped-default training of this many steps")
    ap.add_argument("--lca-protocol", type=int, default=0,
                    help="also run the LCA anchor's protocol (compact_engage_max 192, "
                         "display_every 1000, log_dir) for this many steps")
    ap.add_argument("--classic-probe", type=int, default=0,
                    help="also run the classic path at three lrs for this many steps each, "
                         "printing its fine loss against an empty field's")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: also time its kernels #1, #2, #3, "
                         "#4 and #6 and split pairs on this run's inputs, hold #1's, #3's, #4's "
                         "and #6's outputs and the ptxas report to it and its dense runs equal "
                         "to this one's")
    ap.add_argument("--time-saved", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=HERE, help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    try:
        from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe
        from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run f32 products
    torch.backends.cudnn.allow_tf32 = False
    if args.time_saved:
        print(json.dumps(time_saved(torch, fm, args.time_saved,
                                    mods=(fk, fs, fe) if args.ptxas else None)))
        return 0
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {kind} count {torch.cuda.device_count()}")
    print(smi)
    report: dict = {"device": kind, "nvidia_smi": smi}
    t_all = time.perf_counter()
    try:
        kb = build_kernels(fm, fk, fs, fe)
        report["build"] = kb
        report["native_build"] = build_native()
        rows = kernel_phase(torch, fm, report)
        ds = make_dataset(torch)
        report["sampling_table_repeats_identical"] = check_sampling_table(torch, ds.rays)
        tr = training_phase(torch, fm, fk, fs, ds, report)
        cp = compact_phase(torch, fm, fk, fs, ds, report)
        fp = fused_step_phase(torch, fm, fk, fs, ds, tr, cp, report)
        bt = bwd_trained_phase(torch, fm, cp["shipped"]["result"].state, fp, report)
        ep = encoded_phase(torch, fm, fk, fs, fe, ds, report)
        graph_phase(torch, fm, fk, fs, ds, cp, ep, report)
        bc = bwd_compare_phase(torch, fm, tr, fp, bt, ep, args.parent, report, kb)
        lca_ds, lca, lca_info = lca_phase(torch, fm, fk, fs, report)
        ev = eval_phase(torch, fm, fk, fs, cp["shipped_best"], cp["shipped"]["result"].page_data,
                        lca_ds, lca_info, report)
        cli = cli_phase(torch, fm, fk, fs, ev, lca_ds, report)
        pp = pose_phase(torch, fm, fk, fs, fe, cp, ep, report)
        cl = classic_phase(torch, fm, fk, fs, ds, report)
        if args.classic_probe:
            classic_probe(torch, fm, fk, fs, ds, args.classic_probe, report)
        if args.determinism:
            determinism_phase(torch, fm, ds, report)
        if args.protocol:
            protocol_phase(torch, ds, args.protocol, report)
        if args.lca_protocol:
            lca_protocol_phase(torch, fm, fk, lca_ds, args.lca_protocol, report)
            lca_protocol_sweep(torch, fm, fk, fs, lca_info, report)
        # the quality bars, held once both protocol runs have their numbers
        if args.protocol:
            best = report["protocol"]["best_heldout_psnr"]
            check(best >= CT_FLOOR_DB, f"CT protocol: best held-out PSNR {best:.3f} dB below "
                                       f"the JAX band's {CT_FLOOR_DB}")
        if args.lca_protocol:
            best = report["lca_protocol"]["best_heldout_psnr"]
            check(best >= LCA_FLOOR_DB, f"LCA protocol: best held-out PSNR {best:.3f} dB below "
                                        f"{LCA_FLOOR_DB} (the JAX anchor 30.12 less 0.8)")
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
            "feature_major_dense": fp["feature_major_dense"],
            "fourier_shipped": ep["fourier_shipped"], "barf_anneal": ep["barf_anneal"],
            "lca": lca, "eval_ct": ev["ct"], "eval_lca": ev["lca"],
            "cli_train": cli["train"], "cli_evaluate": cli["evaluate"],
            "pose_shipped": pp["shipped"],
            **{f"pose_step {k}": v for k, v in pp["steps"].items()},
            "pose_replay": pp["replay"]["counts"], "pose_recovery": pp["recovery"],
            "pose_cli": pp["cli"], **{f"classic {k}": v for k, v in cl.items()}}
    # every count was read around its run: a run without one is a KeyError
    by_path = {
        name: {k: r[key] for k, r in runs.items()}
        for name, key in (("fused_mlp_fwd", "fwd_launches"), ("fused_mlp_bwd", "bwd_launches"),
                          ("first_k_active", "first_k_launches"),
                          ("fused_step", "fused_step_launches"),
                          ("fused_mlp_enc_fwd", "enc_fwd_launches"),
                          ("fused_mlp_enc_bwd", "enc_bwd_launches"))
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
    # both weight sets at every shape: tile shares, the bounds over the tiles
    # the kernel computes, its parts, and with --parent the paired times
    fs_paired, fs_parent = (bc.get(side, {}) for side in ("paired", "parent"))
    rows[-1]["cases"] = {
        f"{name}, {w} weights": {
            **{q: v[w][q] for q in ("actives", "draw_actives", "mask_tile_share",
                                    "draw_tile_share", "ms", "plain_ms", "bound_ms",
                                    "tile_bound_ms", "floor_ms", "parts_ms", "max_abs_err")},
            **{f"{side}_{q}": src.get(f"fs_{q}", {}).get(f"{name}, {w} weights")
               for side, src in (("paired", fs_paired), ("parent", fs_parent))
               for q in ("ms", "parts_ms")}}
        for name, v in fp["shapes"].items() for w in ("random", "trained")}
    rows[-1]["vs_parent"] = bc.get("fs_vs_parent")
    rows += ep["rows"]
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
    # with --parent: both checkouts' means in fresh processes (paired_times)
    parent_ms = bc.get("parent", {}).get("bwd_ms", {})
    paired_ms = bc.get("paired", {}).get("bwd_ms", {})
    parent_parts = bc.get("parent", {}).get("bwd_parts_ms", {})
    paired_parts = bc.get("paired", {}).get("bwd_parts_ms", {})
    rows[1]["traffic_floor_ms"] = bc["floor_ms"][f"random: P={BWD_RANDOM_P[0]}"]
    rows[1]["random_g"] = {k: dict(ms=v, floor_ms=bc["floor_ms"][k], paired_ms=paired_ms.get(k),
                                   parent_ms=parent_ms.get(k), paired_parts_ms=paired_parts.get(k),
                                   parent_parts_ms=parent_parts.get(k))
                           for k, v in bc["ms"].items() if k.startswith("random")}
    rows[1]["trained_state"] = {
        k: {**{q: r[q] for q in ("P", "active_tile_share", "active_point_share", "ms",
                                 "plain_ms", "bound_ms", "bound_by", "floor_ms")},
            "paired_ms": paired_ms.get(f"trained: {k}"),
            "parent_ms": parent_ms.get(f"trained: {k}"),
            "paired_parts_ms": paired_parts.get(f"trained: {k}"),
            "parent_parts_ms": parent_parts.get(f"trained: {k}")}
        for k, r in bt["rows"].items()}
    enc_parent = bc.get("parent", {})
    enc_paired = bc.get("paired", {})
    enc_row = next(r for r in rows if r["name"] == "fused_mlp_enc_bwd")
    enc_row["random_g"] = {k: dict(ms=v, paired_ms=enc_paired.get("enc_bwd_ms", {}).get(k),
                                   parent_ms=enc_parent.get("enc_bwd_ms", {}).get(k),
                                   paired_parts_ms=enc_paired.get("enc_bwd_parts_ms", {}).get(k),
                                   parent_parts_ms=enc_parent.get("enc_bwd_parts_ms", {}).get(k))
                           for k, v in bc["enc_ms"].items() if k.startswith("random")}
    enc_row["trained_state"] = {
        k: {**{q: r[q] for q in ("P", "active_tile_share", "active_point_share", "ms",
                                 "plain_ms", "bound_ms", "bound_by", "floor_ms")},
            **{f"{side}_{q}": src.get(f"enc_bwd_{q}", {}).get(f"trained: fourier, {k}")
               for side, src in (("paired", enc_paired), ("parent", enc_parent))
               for q in ("ms", "parts_ms")}}
        for k, r in ep["trained"].items()}
    enc_row["vs_parent"] = bc.get("enc_vs_parent")
    rows[0]["hgmma"] = kb["hgmma_total"]
    rows[0]["ptxas"] = {k: v for k, v in kb["ptxas"]["fused_mlp"].items()
                        if "wgmma_fwd_kernel" in k}
    rows[0]["compact_step_profile_ms"] = cp["profile"].get("fwd_kernel_ms")
    rows[0]["paired_ms"] = bc.get("paired", {}).get("fwd_ms")
    rows[0]["parent_ms"] = bc.get("parent", {}).get("fwd_ms")
    rows[0]["paired_one_launch_ms"] = bc.get("paired", {}).get("fwd_one_ms")
    rows[0]["parent_one_launch_ms"] = bc.get("parent", {}).get("fwd_one_ms")
    rows[0]["vs_parent"] = bc.get("fwd_vs_parent")
    enc_fwd_row = next(r for r in rows if r["name"] == "fused_mlp_enc_fwd")
    enc_fwd_row["hgmma"] = kb["hgmma_enc_total"]
    enc_fwd_row["ptxas_128_ke48"] = kb["enc_fwd_ptxas"]
    for key, q in (("paired_ms", "paired"), ("parent_ms", "parent")):
        enc_fwd_row[key] = bc.get(q, {}).get("enc_fwd_ms")
        enc_fwd_row[key.replace("_ms", "_one_launch_ms")] = bc.get(q, {}).get("enc_fwd_one_ms")
    enc_fwd_row["vs_parent"] = bc.get("enc_fwd_vs_parent")
    # kernels #1, #2 and #5 at the LCA path's shapes (lca_kernel_checks)
    fk_table_row = next(r for r in rows if r["name"] == "first_k_active")
    rows[1]["lca"], fk_table_row["lca"] = {}, {}
    for phase in ("lca", "lca_protocol"):
        lk = report.get(phase, {}).get("kernels")
        if lk is None:
            continue
        rows[0]["shapes"].update({r["label"]: {k: r[k] for k in (
            "P", "ms", "ms_back_to_back", "plain_ms", "bound_ms", "max_abs_err", "median_abs_err",
            "feature_major_equal")} for r in lk["fwd"]})
        rows[1]["lca"].update({r["label"]: {k: r.get(k) for k in (
            "P", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "dx_bad_share",
            "active_tile_share")} for r in lk["bwd"]})
        fk_table_row["lca"].update({
            f"{phase}: R={r['R']} w={r['w']} k={r['k']}": {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for r in lk["first_k"]})
    # kernels #2 and #4 at the pose steps' own g (pose_step_check; bound over the active tiles)
    pose_keys = ("P", "active_tile_share", "dx_bad_share", "dx_rel_l2", "dx_zero_on_skipped",
                 "grad_norm_err", "view_shifts_grad_norm_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "floor_ms")
    rows[1]["pose"] = {k: {q: v[q] for q in pose_keys} for k, v in pp["steps"].items()
                       if not k.startswith("fourier")}
    enc_row["pose"] = {k: {q: v[q] for q in pose_keys} for k, v in pp["steps"].items()
                       if k.startswith("fourier")}
    rows += eval_rows(ev, by_path)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
