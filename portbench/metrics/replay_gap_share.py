"""replay_gap_share (%): the share of the chunk calls' device span (CUDA
events around each call's replays, the calls that only replayed) outside
the steps' own spans, over the whole window: 1 - (the step span a replayed
step) x (the steps of those calls) / (their device span), summed over the
jobs. The card idle between replays: graph launches the host issues late,
and each graph's start and end."""

from portbench.spans import totals


def read(ctx):
    tot = totals(ctx)
    if (tot is None or not tot["span_steps"] or not tot["chunk_device_s"]
            or "step" not in tot["spans"]):
        return None
    busy_ms = tot["spans"]["step"] / tot["span_steps"] * tot["chunk_replays"]
    return 100.0 * (1.0 - busy_ms / (1e3 * tot["chunk_device_s"]))
