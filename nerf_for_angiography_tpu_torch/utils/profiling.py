"""Tracing and profiling utilities (port of
``nerf_for_angiography_tpu/utils/profiling.py``).

The reference's only instrumentation is a wall-clock pair printed every 500
iterations (run_nerf_acc.py:264,335-336); the training loop prints its own
ms/iter. Here:
  * ``trace``: a context manager around ``torch.profiler`` that writes a
    Chrome trace (``trace.json``, which Perfetto and chrome://tracing open)
    into a directory;
  * ``annotate``: the one span primitive. Under a running profiler it is a
    named range (a ``record_function``, and an NVTX range on the card);
    while a ``SpanRecorder`` is active it also marks the span's device
    times, inside a CUDA graph's capture too, so every replay of the graph
    times its spans again. With neither it does nothing;
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
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# how many debug_nans blocks are open (the flag train() reads)
_nan_checks = 0
# the SpanRecorder annotate marks spans into (None: no recorder is active)
_recorder = None


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


class SpanRecorder:
    """The spans ``annotate`` marks while the recorder is active (``with
    recorder:``), and their times once the marks have been taken.

    A mark on the card is a launch of ``ops/kernels/stamp.py``'s one-thread
    kernel, which writes the card's clock (ns) into a slot of the recorder's
    device buffer in stream order: inside a CUDA graph's capture the launch
    is a node of the graph, and each replay writes the slots again. On the
    CPU a mark reads ``time.perf_counter_ns`` (a CPU step is synchronous).

    The top-level spans of a step follow one another, so a top-level span's
    end is the next one's start (one mark serves both, and an operation
    between two spans counts to the earlier), and a span that opens where
    another of its name has just closed goes on as that span. A nested span
    (depth > 0) takes a mark at each end."""

    SLOTS = 64  # marks a recorder can take (a train step takes 12 to 16)

    def __init__(self, device: torch.device | str = "cpu"):
        device = torch.device(device)
        self._slots = None
        if device.type == "cuda":
            from ..ops.kernels.stamp import stamp_cuda

            # the buffer and the kernel (built, loaded and launched once)
            # exist before any capture the recorder marks in
            self._slots = torch.zeros((self.SLOTS,), dtype=torch.int64, device=device)
            stamp_cuda(self._slots, 0)
        self._host: list[int] = []
        self.n = 0  # marks taken
        self.spans: list[list] = []  # [name, depth, first mark, last mark]
        self.depth = 0
        self._pending = None  # a closed top-level span whose end is not marked yet
        self._outer = None

    def __enter__(self):
        global _recorder
        self._outer, _recorder = _recorder, self
        return self

    def __exit__(self, exc_type, *exc):
        global _recorder
        _recorder = self._outer
        if self._pending is not None and exc_type is None:
            self._pending[3] = self._mark()
        self._pending = None
        return False

    def _mark(self) -> int:
        if self.n == self.SLOTS:
            raise RuntimeError(f"a SpanRecorder takes at most {self.SLOTS} marks")
        if self._slots is not None:
            from ..ops.kernels.stamp import stamp_cuda

            stamp_cuda(self._slots, self.n)
        else:
            self._host.append(time.perf_counter_ns())
        self.n += 1
        return self.n - 1

    def open(self, name: str) -> list:
        """A span opens (annotate's entry)."""
        prev, self._pending = self._pending, None
        if prev is not None and prev[0] == name:
            self.depth += 1
            return prev
        mark = self._mark()
        if prev is not None:
            prev[3] = mark
        span = [name, self.depth, mark, None]
        self.spans.append(span)
        self.depth += 1
        return span

    def close(self, span: list) -> None:
        """A span closes (annotate's exit)."""
        self.depth -= 1
        if self.depth == 0:
            self._pending = span
        else:
            span[3] = self._mark()

    def times_ns(self) -> list[int]:
        """The marks' times (ns); on the card read once the marks are done."""
        if self._slots is None:
            return list(self._host)
        return self._slots[: self.n].tolist()

    def read(self) -> dict[str, float]:
        """{span name: ms summed over its spans, and "step": the first mark
        to the last}; {} before any span."""
        if not self.spans:
            return {}
        t = self.times_ns()
        out: dict[str, float] = {}
        for name, _, a, b in self.spans:
            out[name] = out.get(name, 0.0) + (t[b] - t[a]) / 1e6
        out["step"] = (t[self.n - 1] - t[0]) / 1e6
        return out


class _Off:
    """The block of an annotate with nothing to record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """The block of an annotate with a profiler range or a recorder (or
    both) to open."""

    __slots__ = ("name", "_range", "_rec", "_span")

    def __init__(self, name: str, rec):
        self.name = name
        self._rec = rec
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
        if self._rec is not None:
            self._span = self._rec.open(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        # a block that raised leaves its recorder (a failed capture's, or
        # a failed CPU step's) unread: nothing more is marked
        if self._rec is not None and exc_type is None:
            self._rec.close(self._span)
        if self._range is not None:
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()
            self._range.__exit__(exc_type, exc, tb)
        return False


def annotate(name: str):
    """A named span: ``with annotate("step/march"): ...``.

    Under a running ``torch.profiler`` it opens a ``record_function`` range
    (and an NVTX range on the card), so the block shows in ``trace``'s
    Chrome trace. While a ``SpanRecorder`` is active it also marks the
    span's times into it. With neither it checks the two flags and returns
    a block that does nothing."""
    rec = _recorder
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, rec)


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
