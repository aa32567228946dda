"""What the step spans cost on the card: replayed steps of one state through
graphs with the spans' timestamp nodes and through the same graphs without
them, in turns in one process; and the host cost of ``annotate`` when no
recorder and no profiler is on.

    python3 tools/torch_span_cost.py [--cell ct_vessel.train] [--iters 4000] [--pairs 6]

Trains ``--iters`` steps of the benchmark cell's configuration and traffic
(``portbench``'s files; job seed 1) to reach the Tuning a job spends most of
its steps at, then builds two chunks of 96 steps (six grid updates each) at
the job's final Tuning: one whose captures run under the span recorder (as
the port's chunks do) and one whose captures mark nothing. Calls them in the
order marked, plain, plain, marked, ``--pairs`` times, each call timed by
CUDA events around it; prints one JSON line (also written to
``chiprun_out/span_cost.json``): the ms a step each way, their difference,
the marked steps' own spans and the off cost of ``annotate`` in ns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="ct_vessel.train")
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--pairs", type=int, default=6)
    a = ap.parse_args(argv)

    import torch

    from nerf_for_angiography_tpu_torch.training import TrainConfig, graph, loop
    from nerf_for_angiography_tpu_torch.training.train import drop_test_view, make_train_chunk
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table
    from nerf_for_angiography_tpu_torch.utils.profiling import SpanRecorder, annotate
    from portbench import run, steps_profile

    class Unmarked(SpanRecorder):
        """A recorder that marks nothing: its captures hold no timestamp node."""

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    spec = run.load_cell(a.cell)
    train, datagen, _ = run.settings(spec["config"], spec["traffic"], 1)
    rays, src_z = run.make_dataset(torch, spec["config"], datagen, dev)
    cfg = TrainConfig(**{**train, "n_iters": a.iters})
    res = loop.train(cfg, rays, src_z, device=dev, verbose=False)
    tuning = res.timing["tuning_final"]
    near, far = src_z - cfg.outside, src_z + cfg.outside
    n_views = int(rays.image_ids.max()) + 1
    tr = drop_test_view(rays, n_views - 1, rays.num_rays // n_views)
    tr = tr._replace(sampling_table=build_sampling_table(tr.weights))
    tcfg = steps_profile.tuning_cfg(cfg, tuning)
    state = res.state
    steps = 6 * cfg.grid_update_every
    chunks = {}
    for name, rec in (("marked", SpanRecorder), ("plain", Unmarked)):
        graph.SpanRecorder = rec  # the class the chunk's captures make
        chunks[name] = make_train_chunk(state.model, tcfg, near, far, steps)
        for _ in range(2):  # warm-ups and captures of every kind
            chunks[name](state, tr)
        torch.cuda.synchronize()
    graph.SpanRecorder = SpanRecorder
    ms = {"marked": [], "plain": []}
    totals = graph.SpanTotals()
    for _ in range(a.pairs):
        for name in ("marked", "plain", "plain", "marked"):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            chunks[name](state, tr)
            e1.record()
            torch.cuda.synchronize()
            ms[name].append(e0.elapsed_time(e1) / steps)
            chunks[name].read_spans(totals if name == "marked" else graph.SpanTotals())
    marked, plain = statistics.median(ms["marked"]), statistics.median(ms["plain"])
    per = {k: v / totals.span_steps for k, v in totals.step_ms.items()}
    marks = sorted({g.spans.n for g in chunks["marked"].graphs.values()})

    def off():
        with annotate("loop/chunk"):
            pass

    def empty():
        pass

    n = 1_000_000
    off_ns = (timeit.timeit(off, number=n) - timeit.timeit(empty, number=n)) / n * 1e9
    out = dict(card=card, cell=a.cell, iters=a.iters, tuning=tuning, steps_per_call=steps,
               ms_marked=ms["marked"], ms_plain=ms["plain"], median_marked=marked,
               median_plain=plain, cost_ms=marked - plain,
               cost_share=(marked - plain) / plain, marks_per_step=marks, spans_ms=per,
               annotate_off_ns=off_ns, time=time.strftime("%Y-%m-%d %H:%M:%S"))
    line = json.dumps(out)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "span_cost.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
