"""A chunk of train steps as replays of captured CUDA graphs (the port's
counterpart of the JAX package's ``make_train_chunk``, a jitted
``lax.scan`` over the steps of a chunk, training/train.py:1094-1130).

An eager step on the card is 130-350 small operations, each issued by the
host; the host takes longer to issue them than the card takes to run them.
A CUDA graph records one step's operations once and replays them with one
launch. A step's operations depend on the host only through its grid update
(none, dense, or one of the slabs: ``ops.occupancy.grid_update_kind``), so
each step callable keeps one graph for each kind it has met. Everything
else that changes from step to step lives on the device: the step counter
the lr and the BARF alpha are computed from, the generator's Philox offset
(registered with each graph, so each replay draws fresh rays and jitter),
the grids and the Adam state, all written in place.

The first step of each kind runs eagerly on a side stream (a real step of
the run), which builds the kernels and creates every lazily made tensor;
the next step of that kind is captured and replayed, and every later one
replayed. A capture runs no work: the host-side step and the launch
counters move only when a graph replays (the launches a capture counted
are taken back and added on each replay, ``captured_launches``). Python's
cyclic collector is off during a capture, so no other graph is freed
inside it. A capture that fails raises; the chunk never falls back to
eager steps on the card.

All graphs of a ``TrainChunk`` share one memory pool (the loop passes one
pool to all of its chunks): they run one after another on one stream, so
one graph's scratch may reuse another's. Each graph keeps its outputs (the
metrics, pixels and gradients of the step it recorded) alive and
overwrites them on every replay: read them before the next replay.

Each capture runs under a ``utils.profiling.SpanRecorder``: the step's
``annotate`` spans (training/train.py) become timestamp nodes of its graph,
which every replay writes again. The chunk counts its replays by kind and
times each call from the host with a pair of CUDA events; ``read_spans``,
after a call's boundary synchronize, reads each replayed kind's last replay
and the call's device span into a ``SpanTotals``.

Under a mesh the step's all-reduces (training/train.py
``_sharded_loss_and_grads``) are captured with it: NCCL collectives are
synchronous graph nodes, and the warm-up step of each kind runs them eagerly
before its capture. Under ``utils.profiling.debug_nans`` every step runs
eagerly, since a capture cannot check its outputs on the host.

On the CPU a chunk runs the eager step ``steps_per_call`` times, each
under a recorder that reads the host clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
import traceback
from typing import Any, Callable

import torch

from ..ops.kernels import first_k, fused_mlp, fused_mlp_enc, fused_step, march
from ..utils.profiling import SpanRecorder, annotate, nan_checks_on

# the wrappers' launch counters (each adds one where it launches its kernel),
# kernel #2's on-chip launches, #2's and #4's launched tiles and points, and
# the compacted marches the march kernels and the op chain ran
_COUNTERS = (
    (fused_mlp, "fwd_launches"), (fused_mlp, "bwd_launches"),
    (fused_mlp_enc, "enc_fwd_launches"), (fused_mlp_enc, "enc_bwd_launches"),
    (first_k, "launches"), (fused_step, "fused_step_launches"),
    (fused_mlp, "bwd_tiles"), (fused_mlp, "bwd_points"), (fused_mlp, "bwd_onchip"),
    (fused_mlp_enc, "enc_bwd_tiles"), (fused_mlp_enc, "enc_bwd_points"),
    (march, "launches"), (march, "march_fused"), (march, "march_chain"),
)


def _counts() -> tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _restore_counts(counts: tuple[int, ...]) -> None:
    for (mod, name), n in zip(_COUNTERS, counts):
        setattr(mod, name, n)


@contextlib.contextmanager
def captured_launches():
    """Within the block (a CUDA graph's capture, which runs no kernel) the
    wrappers count as they always do; at its end the launches they counted
    go to the yielded tally and the counters are set back."""
    before = _counts()
    tally: dict = {}
    try:
        yield tally
    finally:
        after = _counts()
        tally.update({key: b - a for key, a, b in zip(_COUNTERS, before, after) if b != a})
        _restore_counts(before)


def add_launches(tally: dict) -> None:
    """A replay of a captured graph: the launches of its tally."""
    for (mod, name), n in tally.items():
        setattr(mod, name, getattr(mod, name) + n)


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def _where(err: BaseException) -> str:
    """The innermost frame of an exception: the call that failed."""
    tb = traceback.extract_tb(err.__traceback__)
    if not tb:
        return type(err).__name__
    f = tb[-1]
    return f"{f.name} ({os.path.basename(f.filename)}:{f.lineno})"


def state_signature(state, rays) -> tuple:
    """The identities a captured step reads and writes: the generator, and
    the addresses of the parameters, the Adam state and lr, the step
    counter, both grids and the ray store. A graph replays only for the
    same ones."""
    opt = state.optimizer
    tensors = [*state.model.parameters(), state.step_dev]
    for group in opt.param_groups:
        if torch.is_tensor(group["lr"]):
            tensors.append(group["lr"])
        for p in group["params"]:
            tensors += [v for v in opt.state.get(p, {}).values() if torch.is_tensor(v)]
    for grid in (state.grid, state.vessel_grid):
        tensors += [t for t in grid if t is not None]
    tensors += [t for t in rays if t is not None]
    return (id(state.generator), tuple(t.data_ptr() for t in tensors))


@dataclasses.dataclass
class SpanTotals:
    """A job's step spans and chunk device spans (``TrainChunk.read_spans``
    adds into it). ``step_ms``: span name -> device ms summed over
    ``span_steps`` replayed steps ("step": the first mark to the last);
    ``chunk_device_s`` / ``chunk_replays``: the device span of the chunk
    calls that only replayed and their steps; ``chunks_left_out``: the
    calls that warmed a kind up or captured one."""

    step_ms: dict = dataclasses.field(default_factory=dict)
    span_steps: int = 0
    chunk_device_s: float = 0.0
    chunk_replays: int = 0
    chunks_left_out: int = 0


class _Captured:
    """One captured step: the graph, the launches it makes, the outputs of
    the step it recorded and the recorder its spans' marks write into (it
    owns the buffer the graph's timestamp nodes write)."""

    def __init__(self, graph, tally: dict, out: tuple, spans: SpanRecorder):
        self.graph = graph
        self.tally = tally
        self.metrics, self.pred, self.target = out[1], out[2], out[3]
        self.spans = spans

    def replay(self, state):
        self.graph.replay()
        add_launches(self.tally)
        state.__dict__["step"] = state.step + 1  # the host counter only
        return state, self.metrics, self.pred, self.target


class TrainChunk:
    """``steps_per_call`` steps of ``body(state, rays, pressure)`` in one
    call (``steps`` others: the loop's partial chunks, which replay the same
    graphs); ``kind_of(state)`` names the graph a step replays. Returns the
    last step's ``(state, metrics, pred, target)``; ``pressure`` holds the
    running elementwise max of the steps' truncation pressure (reset at the
    start of each call). ``compile_s`` accumulates the host seconds of the
    first step and of every capture (the loop charges them to "compile");
    ``captures`` counts the graphs captured. ``read_spans`` reads the
    spans of the last call."""

    def __init__(self, body: Callable, kind_of: Callable, steps_per_call: int,
                 pool: Any = None, pressure: torch.Tensor | None = None):
        self.body = body
        self.kind_of = kind_of
        self.steps_per_call = steps_per_call
        self.pool = pool
        self.pressure = pressure
        self.graphs: dict[Any, _Captured] = {}
        self.warm: set = set()  # the kinds whose eager warm-up step has run
        self.compile_s = 0.0
        self.captures = 0
        self._signature = None
        self._side = None
        self._first = True
        self._replays: dict = {}  # kind -> steps since the last read_spans
        self._spans_of: dict = {}  # kind -> the recorder of its last step
        self._edges = None  # the timing events around a call on the card
        self._call = None  # (start, end, steps, cold) of the last call
        self._cold = False  # the call warmed a kind up or captured one

    def __call__(self, state, rays, steps: int | None = None):
        dev = state.step_dev.device
        if self.pressure is None:
            self.pressure = torch.zeros((5,), dtype=torch.int32, device=dev)
        self.pressure.zero_()
        if dev.type == "cuda":
            sig = state_signature(state, rays)
            if sig != self._signature:
                self.release()  # graphs of other tensors
                self._signature = sig
        n = self.steps_per_call if steps is None else steps
        self._cold = False
        if dev.type == "cuda":
            if self._edges is None:
                self._edges = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            self._edges[0].record()
        else:
            t0 = time.perf_counter_ns()
        out = None
        for _ in range(n):
            out = self.step(state, rays)
        if dev.type == "cuda":
            self._edges[1].record()
            self._call = (*self._edges, n, self._cold)
            # the graphs hold the tensors there are now: a fresh state's
            # first call creates the Adam state in its warm-up steps
            self._signature = state_signature(state, rays)
        else:
            self._call = (t0, time.perf_counter_ns(), n, False)
        return out

    def read_spans(self, totals: SpanTotals) -> None:
        """Add the last call's spans into ``totals``; call once the call's
        work is done (after the boundary synchronize). Each kind that
        stepped since the last read contributes its last step's spans (a
        replay's on the card) times its step count; the call's device span
        counts if it only replayed."""
        for kind, n in self._replays.items():
            for name, ms in self._spans_of[kind].read().items():
                totals.step_ms[name] = totals.step_ms.get(name, 0.0) + ms * n
            totals.span_steps += n
        self._replays.clear()
        call, self._call = self._call, None
        if call is None:
            return
        start, end, n, cold = call
        if cold:
            totals.chunks_left_out += 1
            return
        on_card = isinstance(start, torch.cuda.Event)
        totals.chunk_device_s += start.elapsed_time(end) / 1e3 if on_card else (end - start) / 1e9
        totals.chunk_replays += n

    def step(self, state, rays):
        """One step: the replay of its kind's graph, or an eager step (every
        step on the CPU and under debug_nans; the warm-up of a kind on the
        card)."""
        if state.step_dev.device.type != "cuda":
            kind = self.kind_of(state)
            self._replays[kind] = self._replays.get(kind, 0) + 1
            rec = self._spans_of[kind] = SpanRecorder()
            with rec:
                return self._eager(state, rays)
        if nan_checks_on():
            self._cold = True
            return self._eager(state, rays)
        kind = self.kind_of(state)
        g = self.graphs.get(kind)
        if g is None:
            self._cold = True
            if kind not in self.warm:
                self.warm.add(kind)
                with annotate("chunk/warmup"):
                    return self._eager(state, rays)
            with annotate("chunk/capture"):
                g = self.graphs[kind] = self._capture(kind, state, rays)
        self._replays[kind] = self._replays.get(kind, 0) + 1
        with annotate("chunk/replay"):
            return g.replay(state)

    def release(self) -> None:
        """Drop every graph (and its outputs); the next step of each kind
        warms up and captures again."""
        self.graphs.clear()
        self.warm.clear()

    def _eager(self, state, rays):
        """The eager step, on a side stream on the card (capture's
        warm-up); the first one is timed to the end of its work."""
        t0 = time.perf_counter()
        if state.step_dev.device.type == "cuda":
            cur = torch.cuda.current_stream()
            if self._side is None:
                self._side = torch.cuda.Stream()
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = self.body(state, rays, self.pressure)
            cur.wait_stream(self._side)
        else:
            out = self.body(state, rays, self.pressure)
        if self._first:  # kernel builds and first launches, as the loop charges them
            self._first = False
            if state.step_dev.device.type == "cuda":
                torch.cuda.synchronize()
            self.compile_s += time.perf_counter() - t0
        return out

    def _capture(self, kind, state, rays) -> _Captured:
        opt = state.optimizer
        # every parameter the warm-up step gave a gradient has its Adam state
        missing = [p for g in opt.param_groups for p in g["params"]
                   if p.grad is not None and p not in opt.state]
        if missing:
            raise GraphCaptureError(
                f"the {kind!r} step cannot be captured before the Adam state exists "
                "(an eager step creates it)")
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        gen = state.generator
        gen_state = gen.get_state()
        graph.register_generator_state(gen)
        step0 = state.step
        spans = SpanRecorder(state.step_dev.device)
        # the replays queued so far are steps: they finish before the
        # capture's own time starts (entering the capture synchronizes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first_err = None
        # a cyclic collection inside the capture could free another graph
        # there (cudaGraphExecDestroy), a call the capture forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with captured_launches() as tally, torch.cuda.graph(graph, pool=self.pool), spans:
                try:
                    out = self.body(state, rays, self.pressure)
                except BaseException as e:
                    first_err = e
                    raise
        except Exception as e:
            # a failed capture leaves its registered generator in capture
            # mode: the state goes on with a generator at the same state
            state.generator = torch.Generator(device=gen.device)
            state.generator.set_state(gen_state)
            err = first_err if first_err is not None else e
            raise GraphCaptureError(
                f"CUDA graph capture of the {kind!r} step (step {step0}) failed at "
                f"{_where(err)}: {err}") from err
        finally:
            if collecting:
                gc.enable()
            state.__dict__["step"] = step0  # the capture ran no step
        self.captures += 1
        self.compile_s += time.perf_counter() - t0
        self._spans_of[kind] = spans
        return _Captured(graph, tally, out, spans)
