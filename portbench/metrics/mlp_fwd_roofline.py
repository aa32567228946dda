"""mlp_fwd_roofline (%): kernel #1's bound (the larger of its operations
at the bf16 peak and its bytes at the HBM peak, launch by launch from its
point counts) over its device time in the profiled steps. Nothing when the
trace holds another number of #1 launches than the steps make."""

from portbench.counts import fwd_bound_s

FWD = "wgmma_fwd_kernel"


def read(ctx):
    prof = ctx["profile"]
    if not prof:
        return None
    hits = [v for name, v in prof["kernels"].items() if FWD in name]
    secs, count = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not secs or count != len(prof["fwd_points"]):
        return None
    n_in, f, nh = ctx["mlp"]
    return 100.0 * sum(fwd_bound_s(p, n_in, f, nh) for p in prof["fwd_points"]) / secs
