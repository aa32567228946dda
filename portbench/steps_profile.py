"""Profiled steps after the window (``--trace 1``).

The window's last reconstruction hands over its final state; the port's
``make_train_chunk`` replays it at the Tuning that ran the most steps
(dense where none did), as captured CUDA graphs, under ``torch.profiler``:
a few warm calls (every grid-update kind met and captured), then one
traced call. From the trace: device seconds by kernel, the busy time (the
union of the kernels' intervals) over the host's span of the traced call,
the device's span (the first kernel's start to the last one's end), the
longest idle gaps named by the runtime call the host was in.
"""

from __future__ import annotations

import dataclasses
import time

from .counts import samples_per_ray

N_STEPS = 64
WARM_CALLS = 2  # 128 steps: every grid-update kind (none, each slab) twice
TOP = 10


def tuning_cfg(cfg, tuning: dict | None):
    """The step settings of one Tuning, as the port's loop builds them."""
    if tuning is None:
        return dataclasses.replace(cfg, compact_samples=0)
    return dataclasses.replace(
        cfg, march_mode=tuning["mode"], compact_samples=tuning["k"],
        hybrid_w_cap=tuning["w_cap"], hybrid_w_lo=tuning["w_lo"], hybrid_k_lo=tuning["k_lo"])


def busiest_tuning(timing: dict, batch: int) -> dict | None:
    """The Tuning of a job's ``steady_phases`` that ran the most steps, or
    None when the dense stepper ran more steps than any."""
    phases = timing.get("steady_phases") or []
    best = max(phases, key=lambda p: p["steps"], default=None)
    if best is None or timing.get("dense_rays", 0) // batch > best["steps"]:
        return None
    return {k: best[k] for k in ("mode", "k", "w_cap", "w_lo", "k_lo")}


def grid_points(step: int, cfg) -> int:
    """MLP points of the grid update at ``step`` (0 when none): every cell
    during the dense warm-up, one slab of the cells after it."""
    cells = cfg.grid_resolution ** 3
    if step % cfg.grid_update_every:
        return 0
    if cfg.grid_update_slabs <= 1 or cfg.grid_resolution % cfg.grid_update_slabs or step < 256:
        return cells
    return cells // cfg.grid_update_slabs


def _union(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_steps(torch, port, state, train_rays, cfg, near: float, far: float,
                  tuning: dict | None) -> dict:
    """Trace ``N_STEPS`` replayed steps of ``state`` at ``tuning``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tcfg = tuning_cfg(cfg, tuning)
    chunk = port.make_train_chunk(state.model, tcfg, near, far, N_STEPS)
    for _ in range(WARM_CALLS):
        chunk(state, train_rays)
    torch.cuda.synchronize()
    step0 = state.step
    # the card's activity alone (kernels, copies and the runtime calls that
    # issue them): tracing every host op would slow the host that feeds the
    # replays, and the card would idle for it
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk(state, train_rays)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    kernels: dict[str, list] = {}
    dev, host = [], []
    for ev in prof.events():
        r = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            dev.append((r.start, r.end, ev.name))
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += (r.end - r.start) / 1e6
            k[1] += 1
        elif ev.device_type == DeviceType.CPU and r.end > r.start:
            host.append((r.start, r.end, ev.name))
    dev.sort()
    gaps: dict[str, float] = {}
    end = dev[0][1] if dev else 0.0
    for a, b, _ in dev[1:]:
        if a > end:
            mid = (a + end) / 2
            cover = [h for h in host if h[0] <= mid <= h[1]]
            name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "no host op"
            gaps[name] = gaps.get(name, 0.0) + (a - end) / 1e6
        end = max(end, b)
    batch = cfg.sample_size ** 2
    marched = int(round(samples_per_ray(tuning, cfg.depth_samples_per_ray, cfg.hybrid_split,
                                        batch) * batch))
    # kernel #1's launches: one a step's march, one a grid update
    fwd_points = [marched] * N_STEPS + [
        p for p in (grid_points(s, cfg) for s in range(step0, step0 + N_STEPS)) if p]
    return dict(
        n_steps=N_STEPS, tuning=tuning, window_s=span,
        device_span_s=(max(b for _, b, _ in dev) - dev[0][0]) / 1e6 if dev else 0.0,
        train_points=marched * N_STEPS, grid_points=sum(fwd_points[N_STEPS:]),
        busy_s=_union([(a, b) for a, b, _ in dev]) / 1e6,
        kernels=kernels, fwd_points=fwd_points,
        device_ops=sorted(([n[:160], s] for n, (s, _) in kernels.items()),
                          key=lambda x: -x[1])[:TOP],
        idle_gaps=sorted(([n[:160], s] for n, s in gaps.items()), key=lambda x: -x[1])[:TOP],
    )
