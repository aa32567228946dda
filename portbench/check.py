"""The comparison that decides ``correct``.

Every reconstruction of the window is watched through its first steps
(``StepTap``): before step 0 its initial weights; after each of the first
three steps the loss the step reports, its rendered pixels and the batch's
targets; after step 0
the first gradient as the optimizer holds it (Adam's first moment over
1 - beta1) and the grid the step marched; after step 2 the weights. Once
the window has closed, the plain reference (portbench/reference/steps.py)
works the same steps out again from each job's seed and the benchmark's
dataset, and ``compare`` reads the gaps of each job; ``worst`` keeps the
largest of each over the jobs:

Leaves: each linear's weight and bias, then an encoding's learnable leaves
(the Fourier coefficients), then the view shifts; ``start``, ``grad`` and
``change`` take every leaf.

- ``start``: the largest absolute difference of the initial leaves (exact);
- ``rows``: targets of the three batches that differ (exact: the same rays);
- ``grid``: cells of the grid after step 0 that differ (exact: the carve and
  the step-0 update);
- ``pixels``: the mean absolute gap of a step's rendered pixels, the
  largest over the three steps. The loss and the gradients sum over every
  sample of a batch, where the float8 control's rounding averages out; a
  pixel sums one ray's. Not the largest pixel gap: a pixel at the
  early-stop cut (transmittance 0.01) moves by about 3e-3 when rounding
  flips its last kept sample, in the port and in the control alike;
- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first gradient's norm, leaf by leaf, the gap between the
  port's norm and the reference's over the larger of the reference's norm
  of that leaf and of the median leaf; the worst leaf;
- ``change``: the same for the leaves' change over the three steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's: measured against the median leaf, such a leaf's gap says nothing.
  Under pose refinement that is the view shifts' leaf, which the next two
  hold on its own scale;
- ``shifts_grad``: under pose refinement, the view shifts' first gradient,
  the gap of the norms over the reference's norm of that leaf (0 without
  shifts);
- ``shifts_change``: the same for the view shifts' change over the three
  steps (0 without shifts): AdamW moves each shift by about its own lr a
  step whatever the gradient's size, so a step that leaves the shifts
  unmoved, or moves them at another lr, reads about 1 here.

Each is held to its limit in portbench/limits/<workload>.json.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

from .reference import steps as reference

HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 3
# the port's dense grid-update warm-up (ops/occupancy.py every_n_step_pair)
GRID_WARMUP_STEPS = 256
CHECKS = ("start", "rows", "grid", "pixels", "loss", "grad", "change", "shifts_grad",
          "shifts_change")


def reference_spec(train: dict, src_pt_z: float) -> dict:
    """The settings the reference follows, from the cell's training
    settings (the same dict the port's TrainConfig is built from). The
    encoding (``pos_enc``) and its settings pass through in ``train``, from
    which the encoding's module reads them (its bands, sigma, window)."""
    f, nl = train["num_hidden_units"], train["num_layers"]
    n_in = reference.encoding(train["pos_enc"]).in_dim(train)
    return dict(
        src_pt_z=float(src_pt_z), outside=float(train["outside"]),
        grid_resolution=int(train["grid_resolution"]),
        depth_samples_per_ray=int(train["depth_samples_per_ray"]),
        occ_stride=int(train["occ_stride"]), carve=bool(train["carve_init"])
        and not train.get("pose_refine", False),
        carve_thresh=float(train["carve_thresh"]), alpha_thre=float(train["alpha_thre"]),
        grid_update_every=int(train["grid_update_every"]),
        grid_ema_decay=float(train["grid_ema_decay"]), grid_warmup_steps=GRID_WARMUP_STEPS,
        early_stop_eps=float(train["early_stop_eps"]), batch=int(train["sample_size"]) ** 2,
        weighted=train["sampling_strategy"] != "random" and train["sampling_impl"] == "overdraw",
        lr=float(train["coarse_lr"]), decay_rate=float(train["decay_rate"]),
        decay_steps=int(train["decay_steps"]), widths=[n_in] + [f] * (nl + 1) + [1],
        pos_enc=train["pos_enc"], train=dict(train),
        pose_refine=bool(train.get("pose_refine", False)),
        pose_lr=float(train.get("pose_lr", 0.0)), pose_start=int(train.get("pose_start", 0)),
        pose_weight_decay=float(train.get("pose_weight_decay", 0.0)),
    )


def program_leaves(model) -> list[torch.Tensor]:
    """The port's trained leaves in the reference's order: each linear's
    weight and bias, then the Fourier coefficients of the positions and
    the view shifts, each where the model has them."""
    leaves = []
    for lin in model.linears():
        leaves += [lin.weight, lin.bias]
    if hasattr(model, "fourier_coefficients_pts"):
        leaves.append(model.fourier_coefficients_pts)
    if hasattr(model, "view_shifts"):
        leaves.append(model.view_shifts)
    return leaves


class StepTap:
    """Watches the first ``N_STEPS`` steps of the next ``train()`` call by
    wrapping the port's ``TrainChunk.step`` (the one place every step passes,
    eager or replayed) for those steps alone. The copies it makes are
    device copies queued behind each step; nothing waits for the card."""

    def __init__(self, chunk_cls):
        self.cls = chunk_cls
        self.orig = None
        self.obs: dict = dict(losses=[], targets=[], pixels=[])

    def __enter__(self):
        self.orig = self.cls.step
        tap, orig = self, self.orig

        def step(chunk, state, rays):
            s = state.step
            if s == 0:
                tap.obs["start"] = [p.detach().clone() for p in program_leaves(state.model)]
            out = orig(chunk, state, rays)
            if s < N_STEPS:
                tap.obs["losses"].append(out[1]["loss/train-pixel-coarse"].detach().clone())
                tap.obs["targets"].append(out[3].detach().clone())
                tap.obs["pixels"].append(out[2].detach().clone())
            if s == 0:
                opt = state.optimizer
                tap.obs["grad0"] = [opt.state[p]["exp_avg"].detach() / (1 - 0.9)
                                    if p in opt.state else None
                                    for p in program_leaves(state.model)]
                tap.obs["binary0"] = state.grid.binary.clone()
            if s == N_STEPS - 1:
                tap.obs["leaves"] = [p.detach().clone() for p in program_leaves(state.model)]
                tap.restore()
            return out

        self.cls.step = step
        return self

    def restore(self) -> None:
        if self.orig is not None:
            self.cls.step = self.orig
            self.orig = None

    def __exit__(self, *exc):
        self.restore()
        return False


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _worst_leaf_gap(prog: list[float], ref: list[float], use: list[bool]) -> float:
    med = statistics.median(ref)
    gaps = [abs(p - r) / max(r, med) for p, r, u in zip(prog, ref, use) if u]
    return max(gaps) if gaps and med > 0 else math.inf


def compare(obs: dict, ref: dict) -> dict:
    """The numbers ``correct`` compares (see the module docstring); inf
    where the port gave nothing to compare. Also ``left_out``: the leaves
    the change leaves out."""
    out = {}
    start = obs.get("start")
    out["start"] = (max(float((a.to(b.device) - b).abs().max()) for a, b in
                        zip(start, ref["start"]))
                    if start and len(start) == len(ref["start"]) else math.inf)
    tg = obs.get("targets", [])
    out["rows"] = (float(sum(int((a.to(b.device) != b).sum()) + abs(a.numel() - b.numel())
                             for a, b in zip(tg, ref["targets"])))
                   if len(tg) == N_STEPS and all(a.shape == b.shape
                                                 for a, b in zip(tg, ref["targets"]))
                   else math.inf)
    b0 = obs.get("binary0")
    out["grid"] = (float((b0.to(ref["binary0"].device) != ref["binary0"]).sum())
                   if b0 is not None and b0.shape == ref["binary0"].shape else math.inf)
    losses = [float(x) for x in obs.get("losses", [])]
    px = obs.get("pixels", [])
    out["pixels"] = (max(float((a.to(b.device).double() - b.double()).abs().mean())
                         for a, b in zip(px, ref["pixels"]))
                     if len(px) == N_STEPS and all(a.shape == b.shape
                                                   for a, b in zip(px, ref["pixels"]))
                     else math.inf)
    out["loss"] = (max(abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"]))
                   if len(losses) == N_STEPS and all(math.isfinite(x) for x in losses)
                   else math.inf)
    g_ref = [_norm(g) for g in ref["grad0"]]
    g0 = obs.get("grad0")
    out["grad"] = (_worst_leaf_gap([_norm(g) for g in g0], g_ref, [True] * len(g_ref))
                   if g0 and len(g0) == len(g_ref) and all(g is not None for g in g0)
                   else math.inf)
    leaves = obs.get("leaves")
    moved = leaves and start and len(leaves) == len(ref["leaves"])
    d_prog = [_norm(a - b) for a, b in zip(leaves, start)] if moved else []
    d_ref = [_norm(a - b) for a, b in zip(ref["leaves"], ref["start"])]
    if moved:
        med = statistics.median(g_ref)
        moving = [g >= 1e-3 * med for g in g_ref]
        out["change"] = _worst_leaf_gap(d_prog, d_ref, moving)
        out["left_out"] = moving.count(False)  # reported beside the checks, not judged
    else:
        out["change"] = math.inf
    out["shifts_grad"] = out["shifts_change"] = 0.0
    if ref["shifts"]:
        out["shifts_grad"] = (_own_gap(_norm(g0[-1]), g_ref[-1])
                              if g0 and len(g0) == len(g_ref) and g0[-1] is not None
                              else math.inf)
        out["shifts_change"] = _own_gap(d_prog[-1], d_ref[-1]) if moved else math.inf
    return out


def _own_gap(prog: float, ref: float) -> float:
    """|prog - ref| over ref (0 when both are 0, inf when ref alone is)."""
    if ref > 0:
        return abs(prog - ref) / ref
    return 0.0 if prog == 0 else math.inf


def worst(numbers: list[dict]) -> dict:
    """The largest of each number over the window's jobs."""
    return {k: max(n.get(k, 0) for n in numbers) for k in set().union(*numbers)}


def load_limits(workload: str, root: str = HERE) -> dict:
    """{check: limit} of a workload (portbench/limits/<workload>.json); a
    limit of null marks a number reported but not compared (one that has no
    upper reading: see PERF.md)."""
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        limits = json.load(f)["limits"]
    missing = set(CHECKS) - set(limits)
    if missing:
        raise ValueError(f"limits of {workload} lack {sorted(missing)}")
    return {k: None if limits[k] is None else float(limits[k]) for k in CHECKS}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in CHECKS}
    return all(limits[k] is None or numbers[k] <= limits[k] for k in CHECKS), table
