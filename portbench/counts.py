"""Operations and bytes of the MLP kernels from their shapes, and the
card's published peaks (NVIDIA H100 SXM data sheet, dense rates).

The MLP is n_in -> F -> nh x (F -> F) -> 1 (the 4x128 CPPN: 3 -> 128, four
128 -> 128 layers, 128 -> 1; 66,048 weights). A point's forward takes two
operations a weight; its training step six (forward, the weight gradient and
the input gradient).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12  # HBM3 bandwidth


def mlp_weights(n_in: int = 3, f: int = 128, nh: int = 4) -> int:
    """Matmul weights of the MLP (biases left out)."""
    return n_in * f + nh * f * f + f


def fwd_flops(points: int, n_in: int = 3, f: int = 128, nh: int = 4) -> float:
    """Operations of kernel #1 over ``points``: two a weight a point."""
    return 2.0 * points * mlp_weights(n_in, f, nh)


def fwd_bytes(points: int, n_in: int = 3, f: int = 128, nh: int = 4) -> float:
    """Bytes kernel #1 has to move once: the float32 positions in, the
    float32 raw density out, the bfloat16 weights and float32 biases of
    every layer, and the float32 output weights and bias."""
    weights = 2 * (n_in * f + nh * f * f) + 4 * (nh + 1) * f + 4 * (f + 1)
    return 4.0 * points * n_in + 4.0 * points + weights


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def fwd_bound_s(points: int, n_in: int = 3, f: int = 128, nh: int = 4) -> float:
    return bound_s(fwd_flops(points, n_in, f, nh), fwd_bytes(points, n_in, f, nh))


def train_flops_per_point(n_in: int = 3, f: int = 128, nh: int = 4) -> float:
    """A training point's operations: forward, weight and input gradients."""
    return 6.0 * mlp_weights(n_in, f, nh)


def samples_per_ray(tuning: dict | None, depth_samples: int, split: float, batch: int) -> float:
    """MLP points a ray of a step's march feeds the MLP: every lattice sample
    when dense (``tuning`` None); k when compacted; with a two-bucket
    Tuning (w_lo > 0 at a split) the first int(batch * split) rays of the
    sorted batch at k_lo (k when k_lo is 0), the rest at k."""
    if tuning is None:
        return float(depth_samples)
    k = tuning["k"]
    if tuning["mode"] == "hybrid" and split > 0.0 and tuning.get("w_lo", 0) > 0:
        cut = int(batch * split)
        k_lo = tuning.get("k_lo", 0) or k
        return (cut * k_lo + (batch - cut) * k) / batch
    return float(k)


def march_points(ctx: dict) -> tuple[float, int]:
    """(MLP points the window's marches fed the MLP, rays stepped), from the
    jobs' ``timing``: ``dense_rays`` at every lattice sample, each
    ``steady_phases`` Tuning's steps (its first step among them) at its
    samples a ray."""
    points, rays = 0.0, 0
    for j in ctx["jobs"]:
        t = j["timing"]
        points += t["dense_rays"] * ctx["depth_samples"]
        rays += t["dense_rays"]
        for ph in t["steady_phases"]:
            r = ph["steps"] * ctx["batch"]
            points += r * samples_per_ray(ph, ctx["depth_samples"], ctx["hybrid_split"],
                                          ctx["batch"])
            rays += r
    return points, rays
