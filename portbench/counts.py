"""Operations and bytes of the MLP kernels from their shapes, and the
card's published peaks (NVIDIA H100 SXM data sheet, dense rates).

The MLP is n_in -> F -> nh x (F -> F) -> 1 (the 4x128 CPPN: 3 -> 128, four
128 -> 128 layers, 128 -> 1; 66,048 weights). A point's forward takes two
operations a weight; its training step six (forward, the weight gradient and
the input gradient).

With a positional encoding of L bands (fourier or BARF) the MLP reads E = 3
+ 6L features a point (the position, a sine and a cosine of each coordinate
at each band: 33 at L = 5, 69,888 weights). Kernels #3 / #4 read the 3 f32
coordinates and form the features on chip; their sincos (3L a point) run on
the CUDA cores and are listed beside the operations (``enc_sincos``), not
counted in them.
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


def _weight_bytes(n_in: int, f: int, nh: int) -> int:
    """The bfloat16 weights and float32 biases of the input and hidden
    layers, and the float32 output weights and bias."""
    return 2 * (n_in * f + nh * f * f) + 4 * (nh + 1) * f + 4 * (f + 1)


def fwd_bytes(points: int, n_in: int = 3, f: int = 128, nh: int = 4) -> float:
    """Bytes kernel #1 has to move once: the float32 positions in, the
    float32 raw density out, the bfloat16 weights and float32 biases of
    every layer, and the float32 output weights and bias."""
    return 4.0 * points * n_in + 4.0 * points + _weight_bytes(n_in, f, nh)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def fwd_bound_s(points: int, n_in: int = 3, f: int = 128, nh: int = 4) -> float:
    return bound_s(fwd_flops(points, n_in, f, nh), fwd_bytes(points, n_in, f, nh))


def bwd_flops(points: float, n_in: int, f: int, nh: int) -> float:
    """Kernel #2's operations over ``points``: the forward recomputed, the
    weight gradients and the input / hidden gradients."""
    fwd = 2.0 * points * (n_in * f + nh * f * f + f)
    dh = 2.0 * points * (nh * f * f + n_in * f)
    return 2.0 * fwd + dh


def bwd_bytes(p: float, active_points: float, n_in: int, f: int, nh: int) -> float:
    """The bytes kernel #2 has to move once: g (f32) of every point, x (3
    f32) of the active points, dx (3 f32) of every point, the packed weights
    (bf16 input layer at n_in rounded up to whole 16-column MMA steps and
    hidden layers, f32 biases and head) and the f32 gradients."""
    weights = _weight_bytes(16 * -(-n_in // 16), f, nh)
    grads = 4 * (n_in * f + nh * f * f + (nh + 1) * f + f + 1)
    return 4.0 * p + 12.0 * active_points + 12.0 * p + weights + grads


def encoding_of(ctx: dict) -> tuple[str, int]:
    """(name, L) of the cell's positional encoding (``ctx["encoding"]``);
    ("none", 0) for a context that names none."""
    enc = ctx.get("encoding") or {}
    name = enc.get("name", "none")
    return name, 0 if name == "none" else int(enc["bands"])


def mlp_inputs(bands: int, n_in: int = 3) -> int:
    """E: the MLP's input features a point, the n_in coordinates and a sine
    and a cosine of each at each of ``bands`` bands."""
    return n_in * (1 + 2 * bands)


def enc_sincos(points: float, bands: int) -> float:
    """The sincos evaluations (a sine and a cosine each) of #3's forward over
    ``points``: one a coordinate a band. On the CUDA cores: beside the
    operations, not in them."""
    return 3.0 * bands * points


def enc_fwd_flops(points: float, bands: int, f: int = 128, nh: int = 4) -> float:
    """Operations of kernel #3 over ``points``: two a weight of the encoded
    stack a point."""
    return fwd_flops(points, mlp_inputs(bands), f, nh)


def enc_fwd_bytes(points: float, bands: int, f: int = 128, nh: int = 4) -> float:
    """Bytes kernel #3 has to move once: the 3 float32 coordinates in and the
    float32 raw density out a point, the weights with the E-wide bfloat16
    first layer, and the 3L float32 coefficients (fourier; BARF's window)."""
    return (4.0 * points * 3 + 4.0 * points + _weight_bytes(mlp_inputs(bands), f, nh)
            + 4 * 3 * bands)


def enc_fwd_bound_s(points: float, bands: int, f: int = 128, nh: int = 4) -> float:
    return bound_s(enc_fwd_flops(points, bands, f, nh), enc_fwd_bytes(points, bands, f, nh))


def enc_bwd_flops(points: float, bands: int, f: int = 128, nh: int = 4) -> float:
    """Operations of kernel #4 over ``points`` (its active points): #2's at
    E, and the dcoeff partials: a multiply-add a sine or cosine feature a
    point (dA += dv x_c)."""
    return bwd_flops(points, mlp_inputs(bands), f, nh) + 2.0 * 6 * bands * points


def enc_bwd_bytes(p: float, active_points: float, bands: int, f: int = 128,
                  nh: int = 4) -> float:
    """Bytes kernel #4 has to move once: #2's at E (g, the active points'
    coordinates, dx, the packed weights, the gradients with dW_in at E),
    the 3L float32 coefficients in and their gradient out. The kernel's
    per-warp dA slots are its own choice and not counted."""
    return bwd_bytes(p, active_points, mlp_inputs(bands), f, nh) + 2 * 4 * 3 * bands


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
