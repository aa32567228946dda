"""The port's own step spans and counters, as each window job's
``TrainResult.timing`` reports them: ``step_spans_ms`` (span name -> device
ms summed over ``span_steps`` replayed steps; "step" the whole step),
``chunk_device_s`` / ``chunk_replays`` (the device span of the chunk calls
that only replayed, and their steps) and ``mlp_bwd_tiles`` (kernel #2's
active and launched 16-point tiles, points and launches). Summed over the
jobs. A program that reports none of them gives nothing, and a metric that
reads them then reports nothing.
"""

from __future__ import annotations

TIMING_KEYS = ("span_steps", "chunk_device_s", "chunk_replays")


def totals(ctx: dict) -> dict | None:
    """{"spans": {name: ms}, "span_steps", "chunk_device_s",
    "chunk_replays", "mlp_bwd_tiles": {...}} over the window's jobs, or
    None when a job reports no step spans."""
    out = {"spans": {}, "mlp_bwd_tiles": {}, **{k: 0 for k in TIMING_KEYS}}
    for j in ctx["jobs"]:
        t = j["timing"]
        if "step_spans_ms" not in t:
            return None
        for name, ms in t["step_spans_ms"].items():
            out["spans"][name] = out["spans"].get(name, 0.0) + ms
        for k in TIMING_KEYS:
            out[k] += t[k]
        for k, v in t.get("mlp_bwd_tiles", {}).items():
            out["mlp_bwd_tiles"][k] = out["mlp_bwd_tiles"].get(k, 0) + v
    return out


def stage_ms(ctx: dict, add: tuple[str, ...], sub: tuple[str, ...] = ()) -> float | None:
    """The ms a replayed step of the spans ``add`` less the spans ``sub``
    (nested in them), over the window's jobs; None without step spans or
    without one of ``add``."""
    tot = totals(ctx)
    if tot is None or not tot["span_steps"] or not all(k in tot["spans"] for k in add):
        return None
    ms = sum(tot["spans"][k] for k in add) - sum(tot["spans"].get(k, 0.0) for k in sub)
    return ms / tot["span_steps"]
