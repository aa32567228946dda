// The whole-train-step gradient of a rectangular march for Hopper (sm_90a):
// MLP forward, Beer-Lambert composite with nerfacc's early-stop keep mask,
// the MSE gradient and the MLP backward, from the march's rays and sample
// midpoints to the pixels and the parameter gradients.
//
// Replaces the TPU kernel nerf_for_angiography_tpu/ops/pallas/fused_step.py
// ::_fs_kernel (line 79), reached through fused_step_grads (line 202).
//
// The function, at the TPU kernel's cast points: per ray r and sample j
// (depth-ascending, p = r * k + j)
//   x      = bf16((o_r * s) + (d_r * s) * t_mid[r, j])
//   sigma  = sigmoid(raw(x))                     (the bf16 layer chain, f32 head)
//   keep_j = mask_j * [exp(-sum_{i<j} sigma_i * (step * mask_i)) >= eps]
//   pixel  = exp(-sum_j sigma_j * (step * keep_j))
//   coef   = -(g_scale * (pixel - target)) * pixel * step,  g_scale = 2 / N
//   draw_j = coef * keep_j * sigma_j * (1 - sigma_j)
// and the parameter gradients are the MLP backward of draw (dL/draw_j of
// L = sum (pixel - target)^2 / N): dh = bf16(w_out * draw), relu masks from
// the bf16 activations, dW/db accumulated in f32.  No dx: positions are not
// differentiable on this path.
//
// Bound: one forward, the dW products and the dh products, 3 x 132,096 FLOP
// a point at F = 128, n_hidden = 4, counted over the active samples (mask
// != 0), the only ones that move the pixel or the gradients: about a tenth
// of the dense lattice's 1,687,500 points on the trained grid (0.07 ms on
// 989 TFLOP/s bf16; 0.68 ms over every point).  The inputs are 8 bytes a
// point.  Compute-bound.
//
// Design.  The TPU kernel walks each ray's k samples in order inside one
// tile of 512 rays: parallel over rays only.  At 16 rays a warp tile the
// card would see 352 warp tiles at the dense shape (1,407 rays of the hi
// bucket: 88) for 132 SMs.  Here the MLP runs sample-parallel, over all
// P = R x k points, and only the composite is per ray.  Only 16-point
// tiles holding an active sample carry MLP work (on the trained grid about
// a tenth of the dense lattice's samples are active):
//   (1) forward over the active tiles with x formed in the kernel from o, d
//       and t_mid (MarchX, no (P, 3) array), keeping only sigma (4 B a point);
//   (2) one thread per ray: the two scans in depth order (keep, pixel) over
//       its active samples, coef, then draw for every sample (0 where
//       masked); the pixels out;
//   (3)-(5) the MLP backward of mlp_chain.cuh with g = draw on the same
//       MarchX input (the chain recomputes the forward of the active tiles
//       bit for bit, stores their bf16 activations and dz; the
//       weight-gradient products over the stages holding active tiles, into
//       f32 partials per chunk; the partial sum in chunk order).
// No float atomics: the gradients are bit-identical from launch to launch.
// The backward keeps the MLP backward's activation scratch (2 x (n_hidden +
// 1) x P x F bf16, 4.3 GB at the dense shape) instead of recomputing per
// sample as the TPU kernel does; keeping dz on chip is later work.

#include "mlp_chain.cuh"

namespace {

constexpr int SCAN_THREADS = 128;

// (2): per ray, keep / pixel / coef / draw in depth order
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const float* __restrict__ sigma, const float* __restrict__ mask,
            const float* __restrict__ target, long long R, int k, float step, float eps,
            float g_scale, float* __restrict__ pixel, float* __restrict__ draw) {
  const long long r = (long long)blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (r >= R) return;
  const float* sg = sigma + r * k;
  const float* mk = mask + r * k;
  // a sample with mask 0 adds exactly 0 to both sums and has draw 0; its
  // sigma is not computed (its tile may have been skipped), so not read
  float s_prune = 0.0f, s_comp = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float mj = mk[j];
    if (mj == 0.0f) continue;
    const float sj = sg[j];
    const float keep = mj * (expf(-s_prune) >= eps ? 1.0f : 0.0f);
    s_comp = __fadd_rn(s_comp, __fmul_rn(sj, __fmul_rn(step, keep)));
    s_prune = __fadd_rn(s_prune, __fmul_rn(sj, __fmul_rn(step, mj)));
  }
  const float px = expf(-s_comp);
  pixel[r] = px;
  const float coef =
      __fmul_rn(__fmul_rn(-__fmul_rn(g_scale, __fsub_rn(px, target[r])), px), step);
  float* dr = draw + r * k;
  s_prune = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float mj = mk[j];
    if (mj == 0.0f) {
      dr[j] = 0.0f;
      continue;
    }
    const float sj = sg[j];
    const float keep = mj * (expf(-s_prune) >= eps ? 1.0f : 0.0f);
    dr[j] = __fmul_rn(__fmul_rn(__fmul_rn(coef, keep), sj), __fsub_rn(1.0f, sj));
    s_prune = __fadd_rn(s_prune, __fmul_rn(sj, __fmul_rn(step, mj)));
  }
}

template <int F>
int launch_step(const MarchX& x, const float* mask, const float* target, long long R,
                float step, float eps, float g_scale, const Params& prm, int nh, float* sigma,
                float* draw, float* pixel, const BwdScratch& s, int n_sms, float* grads,
                cudaStream_t st) {
  const long long P = R * x.k;
  int e = launch_fwd<F, MarchX, true>(x, P, prm, nh, sigma, n_sms, st);
  if (e != (int)cudaSuccess) return e;
  if (R > 0) {
    scan_kernel<<<(unsigned)((R + SCAN_THREADS - 1) / SCAN_THREADS), SCAN_THREADS, 0, st>>>(
        sigma, mask, target, R, x.k, step, eps, g_scale, pixel, draw);
    e = (int)cudaGetLastError();
    if (e != (int)cudaSuccess) return e;
  }
  return launch_bwd<F, MarchX>(x, draw, P, prm, nh, DxOut{nullptr, 0, 0}, s, n_sms, grads, st);
}

}  // namespace

extern "C" {

// sizes the caller allocates by: out[0] dynamic shared memory of the
// forward/chain launches (0 for an unsupported width), out[1] floats per
// chunk partial, out[2] floats in the flat gradient, out[3] 8-byte relu-mask
// slots, out[4] points per weight-gradient stage (chunks are multiples)
void fused_step_sizes(int F, int nh, int n_sms, long long* out) {
  out[0] = dims_ok(F, nh) ? (long long)weight_layout(F, nh).total : 0;
  out[1] = (long long)grad_layout(F, nh).stride;
  out[2] = (long long)grad_layout(F, nh).n;
  out[3] = mask_slots(n_sms, nh);
  out[4] = KB;
}

// o, d: (R, 3); t_mid, mask: (R, k); target: (R,) f32.  sigma, draw: (R k,)
// f32 scratch; pixel: (R,) out; acts, dzs: (nh + 1, R k, F) bf16 scratch;
// masks, partials, n_chunks, chunk as fused_mlp_bwd; grads: the flat
// gradient (mlp_chain.cuh GradLayout)
int fused_step_grads(const float* o, const float* d, const float* t_mid, const float* mask,
                     const float* target, long long R, int k, float input_scale, float step,
                     float eps, float g_scale, const void* w_in, const void* w_hid,
                     const float* bias, const float* w_out, const float* b_out, int F, int nh,
                     float* sigma, float* draw, float* pixel, void* acts, void* dzs, void* masks,
                     float* partials, int n_chunks, long long chunk, int n_sms, float* grads,
                     void* stream) {
  const BwdScratch s{static_cast<bf16*>(acts), static_cast<bf16*>(dzs),
                     static_cast<uint2*>(masks), partials, n_chunks, chunk};
  if (!dims_ok(F, nh) || R < 0 || k < 1 || n_sms <= 0 || !scratch_ok(s, R * k, n_sms))
    return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const MarchX x{o, d, t_mid, mask, k, input_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, launch_step<FF>(x, mask, target, R, step, eps, g_scale, prm, nh, sigma,
                                          draw, pixel, s, n_sms, grads, st))
}

}  // extern "C"
