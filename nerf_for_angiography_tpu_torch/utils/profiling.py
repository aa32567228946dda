"""Tracing and profiling utilities (port of
``nerf_for_angiography_tpu/utils/profiling.py``).

The reference's only instrumentation is a wall-clock pair printed every 500
iterations (run_nerf_acc.py:264,335-336). Here:
  * ``StepTimer``: per-step timing with an EMA and the reference's printed
    "Time for iteration N" line;
  * ``trace``: a context manager around ``torch.profiler`` that writes a
    Chrome trace (``trace.json``, which Perfetto and chrome://tracing open)
    into a directory;
  * ``annotate``: a named range inside a traced region (a profiler
    ``record_function``, and an NVTX range on the card);
  * ``debug_nans``: scoped NaN checking that raises ``FloatingPointError``
    at the first operation whose output holds a NaN, naming it, and turns on
    autograd's anomaly mode for the backward. ``train()`` steps eagerly
    while it is on (a captured CUDA graph cannot check its outputs).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# how many debug_nans blocks are open (the flag train() reads)
_nan_checks = 0


class StepTimer:
    """EMA step timer; ``.iteration_line(n)`` matches the reference's print
    format at run_nerf_acc.py:336."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s = None
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg_s = dt if self.avg_s is None else (
            self.ema * self.avg_s + (1 - self.ema) * dt
        )
        return dt

    def iteration_line(self, n_iter: int) -> str:
        return f"Time for iteration {n_iter} = {self.avg_s}"

    def rays_per_sec(self, rays_per_step: int) -> float:
        return rays_per_step / self.avg_s if self.avg_s else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write its Chrome trace to
    ``<log_dir>/trace.json``. Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a traced step: a ``record_function`` range in
    the profiler's trace, and an NVTX range when a card is present."""
    nvtx = torch.cuda.nvtx.range(name) if torch.cuda.is_available() else contextlib.nullcontext()
    with torch.profiler.record_function(name), nvtx:
        yield


class _NanCheck(TorchDispatchMode):
    """Checks the floating outputs of every operation dispatched while it is
    on, and raises at the first that holds a NaN. The allocations (empty,
    new_empty_strided, resize_, ...) are not checked: their memory is not
    written yet."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if "empty" in name or "resize" in name:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def nan_checks_on() -> bool:
    """Whether a ``debug_nans(True)`` block is open."""
    return _nan_checks > 0


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checking: every operation's output is checked on the host
    (each check waits for the device), and the first that holds a NaN raises
    ``FloatingPointError`` naming the operation; the backward runs under
    ``torch.autograd.set_detect_anomaly``. ``enable=False`` checks
    nothing."""
    global _nan_checks
    if not enable:
        yield
        return
    _nan_checks += 1
    try:
        with torch.autograd.set_detect_anomaly(True), _NanCheck():
            yield
    finally:
        _nan_checks -= 1
