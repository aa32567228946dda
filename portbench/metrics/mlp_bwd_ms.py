"""mlp_bwd_ms (ms): kernel #2's device time a profiled step, its launches
over the point-major input: ``onchip_bwd_kernel<F, GatedX>`` (F = 64, 128;
other widths the chain and the weight gradients, ``bwd_chain_kernel<F,
GatedX>`` and ``wgrad_kernel<F, GatedX>``; the encoded and whole-step
kernels instantiate them over other inputs) and the partial sums'
reduction. Nothing in a cell with a positional encoding: #4 does its
backward, and launches a ``reduce_partials`` of its own."""

from portbench.counts import encoding_of

PARTS = ("::GatedX>", "reduce_partials")


def read(ctx):
    prof = ctx["profile"]
    if not prof or encoding_of(ctx)[0] != "none":
        return None
    secs = sum(v[0] for name, v in prof["kernels"].items() if any(p in name for p in PARTS))
    return 1e3 * secs / prof["n_steps"] if secs else None
