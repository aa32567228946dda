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

On the CPU a chunk runs the eager step ``steps_per_call`` times.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
import traceback
from typing import Any, Callable

import torch

from ..ops.kernels import first_k, fused_mlp, fused_mlp_enc, fused_step

# the wrappers' launch counters (each adds one where it launches its kernel)
_COUNTERS = (
    (fused_mlp, "fwd_launches"), (fused_mlp, "bwd_launches"),
    (fused_mlp_enc, "enc_fwd_launches"), (fused_mlp_enc, "enc_bwd_launches"),
    (first_k, "launches"), (fused_step, "fused_step_launches"),
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


class _Captured:
    """One captured step: the graph, the launches it makes and the outputs
    of the step it recorded."""

    def __init__(self, graph, tally: dict, out: tuple):
        self.graph = graph
        self.tally = tally
        self.metrics, self.pred, self.target = out[1], out[2], out[3]

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
    ``captures`` counts the graphs captured."""

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
        out = None
        for _ in range(self.steps_per_call if steps is None else steps):
            out = self.step(state, rays)
        if dev.type == "cuda":
            # the graphs hold the tensors there are now: a fresh state's
            # first call creates the Adam state in its warm-up steps
            self._signature = state_signature(state, rays)
        return out

    def step(self, state, rays):
        """One step: the replay of its kind's graph, or an eager step (every
        step on the CPU; the warm-up of a kind on the card)."""
        if state.step_dev.device.type != "cuda":
            return self._eager(state, rays)
        kind = self.kind_of(state)
        g = self.graphs.get(kind)
        if g is not None:
            return g.replay(state)
        if kind not in self.warm:
            self.warm.add(kind)
            return self._eager(state, rays)
        g = self.graphs[kind] = self._capture(kind, state, rays)
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
            with captured_launches() as tally, torch.cuda.graph(graph, pool=self.pool):
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
        return _Captured(graph, tally, out)
