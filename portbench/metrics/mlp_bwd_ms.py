"""mlp_bwd_ms (ms): kernel #2's device time a profiled step, its three
launches: the chain and the weight gradients over the point-major input
(``bwd_chain_kernel<F, GatedX>``, ``wgrad_kernel<F, GatedX>``; the
encoded and whole-step kernels instantiate them over other inputs) and the
partial sums' reduction."""

PARTS = ("::GatedX>", "reduce_partials")


def read(ctx):
    prof = ctx["profile"]
    if not prof:
        return None
    secs = sum(v[0] for name, v in prof["kernels"].items() if any(p in name for p in PARTS))
    return 1e3 * secs / prof["n_steps"] if secs else None
