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
// Bound: one forward over the samples with mask != 0 (the only ones whose
// sigma moves the pixel) and the dW and dh products over the samples with
// draw != 0 (the only ones that move the gradients), 132,096 FLOP a point
// and product at F = 128, n_hidden = 4.  At the dense lattice on the
// trained grid about a tenth of the 1,687,500 samples have mask != 0, and
// fewer a draw != 0: counted three times over the mask-active samples that
// is 0.07 ms on 989 TFLOP/s bf16 (0.68 ms over every sample).  The inputs
// are 8 bytes a sample.  Compute-bound in the function; the design below
// also round-trips 8 (n_hidden + 1) F bytes of scratch a draw-active tile
// point (chip_smoke.py prints both figures over the draw-active tiles).
//
// Design.  The TPU kernel walks each ray's k samples in order inside one
// tile of 512 rays: parallel over rays only.  At 16 rays a warp tile the
// card would see 352 warp tiles at the dense shape (1,407 rays of the hi
// bucket: 88) for 132 SMs.  Here the MLP runs sample-parallel over 16-point
// tiles of the P = R x k samples, and only the composite is per ray:
//   (0) a list of the tiles that hold a sample with mask != 0 (one ballot a
//       tile, int atomics: the order does not change any bit of (1)), kept
//       in the chain's dz scratch, which (3) writes only after (1) read it;
//   (1) the forward over the listed tiles on warpgroup MMA
//       (mlp_wgmma.cuh's wgmma_march_fwd_kernel: the four warps of a
//       warpgroup take four listed tiles, x formed in the kernel from o, d
//       and t_mid, no (P, 3) array), keeping only sigma (4 B a sample);
//   (2) the composite scan, 32 rays a block: their rows of sigma and mask
//       staged in shared memory with coalesced loads, one thread a ray
//       walking its row in depth order (the sums of one thread a ray over
//       device memory, in the same order, so the same bits: no parallel
//       scan, the early-stop keep at an eps tie depends on the order), the
//       keeps written back coalesced, then every thread forming the draws
//       of the block's samples; the pixels out;
//   (3)-(5) the MLP backward of mlp_chain.cuh with g = draw on GatedMarchX:
//       only tiles holding a sample with draw != 0 (at least every tile
//       skipped by the mask, and those cut off by the early stop) are
//       recomputed (bit for bit), their bf16 activations and dz stored in
//       the tile-fragment layout; the weight-gradient stages hold those
//       tiles only, into f32 partials per chunk; the partial sum in chunk
//       order.  A skipped tile adds exact zeros, so the gradients equal the
//       unskipped ones but for the sign of a zero.
// No float atomics: the gradients are bit-identical from launch to launch.
// The backward keeps the MLP backward's activation scratch (2 x (n_hidden +
// 1) x P x F bf16, 4.3 GB at the dense shape) instead of recomputing per
// sample as the TPU kernel does; storing the forward's activations in (1)
// so that (3) skips its recompute, and keeping dz on chip, are later work.

#include "mlp_chain.cuh"
#include "mlp_wgmma.cuh"

namespace {

constexpr int LIST_WARPS = 8;      // tile list: warps a block, 32 tiles a warp
constexpr int SCAN_RAYS = 32;      // composite scan: rays a block, one walking thread each
constexpr int SCAN_THREADS = 256;  // threads of a scan block (staging, draws)
constexpr int SCAN_COLS = 128;     // samples of each ray staged at a time
constexpr int SCAN_UNROLL = 4;     // draws a thread forms from loads issued together
constexpr int SERIAL_THREADS = 128;  // the one-thread-a-ray reference scan: rays a block

// (0) the 16-point tiles holding a sample with mask != 0: list[0 .. *count)
// (tile indices, in no fixed order); *count zeroed by the caller.  A warp
// reads its 32 tiles' 512 samples 32 consecutive ones at a time.
__global__ void __launch_bounds__(LIST_WARPS * 32)
tile_list_kernel(const float* __restrict__ mask, long long P, int* __restrict__ list,
                 int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const long long tile0 = ((long long)blockIdx.x * LIST_WARPS + (threadIdx.x >> 5)) * 32;
  bool act = false;  // of tile tile0 + lane
#pragma unroll 4
  for (int i = 0; i < TILE; ++i) {
    const long long p = tile0 * TILE + i * 32 + lane;
    const unsigned b = __ballot_sync(0xffffffffu, p < P && mask[p] != 0.0f);
    if (lane == 2 * i) act = (b & 0xFFFFu) != 0u;
    if (lane == 2 * i + 1) act = (b >> 16) != 0u;
  }
  const unsigned bits = __ballot_sync(0xffffffffu, act);
  if (bits == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(bits));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (act) list[base + __popc(bits & ((1u << lane) - 1u))] = (int)(tile0 + lane);
}

// (2): per ray, keep / pixel / coef / draw in depth order.  Ray r0 + t is
// walked by thread t < SCAN_RAYS from shared memory; draw holds the keeps
// until the draws replace them.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const float* __restrict__ sigma, const float* __restrict__ mask,
            const float* __restrict__ target, long long R, int k, float step, float eps,
            float g_scale, float* __restrict__ pixel, float* __restrict__ draw) {
  __shared__ float sg[SCAN_RAYS][SCAN_COLS + 1];  // + 1: the walkers' reads hit 32 banks
  __shared__ float mk[SCAN_RAYS][SCAN_COLS + 1];  // the mask, then the keep
  __shared__ float coef[SCAN_RAYS];
  const long long r0 = (long long)blockIdx.x * SCAN_RAYS;
  const int nr = (int)(R - r0 < SCAN_RAYS ? R - r0 : SCAN_RAYS);
  const int t = threadIdx.x;
  const long long q0 = r0 * k;  // the block's rows are contiguous from here
  float s_prune = 0.0f, s_comp = 0.0f;
  for (int j0 = 0; j0 < k; j0 += SCAN_COLS) {
    const int nc = k - j0 < SCAN_COLS ? k - j0 : SCAN_COLS;
#pragma unroll 4
    for (int i = t; i < nr * nc; i += SCAN_THREADS) {
      const int rr = i / nc, c = i % nc;
      const long long p = q0 + (long long)rr * k + j0 + c;
      sg[rr][c] = sigma[p];
      mk[rr][c] = mask[p];
    }
    __syncthreads();
    if (t < nr) {
      // branch-free, so that the exponentials of consecutive samples
      // overlap: a masked sample adds +0 to both sums (its sigma, which may
      // not have been computed, is not used), as skipping it would
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const float mj = mk[t][c];
        const float sj = mj == 0.0f ? 0.0f : sg[t][c];
        const float keep = mj * (expf(-s_prune) >= eps ? 1.0f : 0.0f);
        s_comp = __fadd_rn(s_comp, __fmul_rn(sj, __fmul_rn(step, keep)));
        s_prune = __fadd_rn(s_prune, __fmul_rn(sj, __fmul_rn(step, mj)));
        mk[t][c] = keep;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = t; i < nr * nc; i += SCAN_THREADS) {
      const int rr = i / nc, c = i % nc;
      draw[q0 + (long long)rr * k + j0 + c] = mk[rr][c];
    }
    __syncthreads();
  }
  if (t < nr) {
    const float px = expf(-s_comp);
    pixel[r0 + t] = px;
    coef[t] = __fmul_rn(__fmul_rn(-__fmul_rn(g_scale, __fsub_rn(px, target[r0 + t])), px), step);
  }
  __syncthreads();
  // the draws of the block's samples (contiguous from q0), SCAN_UNROLL a
  // thread with their loads issued together: 0 where masked (sigma there
  // is not used), else coef keep sigma (1 - sigma) with the keep from draw
  const int n = nr * k;
  for (int i0 = t; i0 < n; i0 += SCAN_UNROLL * SCAN_THREADS) {
    float mj[SCAN_UNROLL], sj[SCAN_UNROLL], kj[SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const int i = i0 + u * SCAN_THREADS;
      mj[u] = i < n ? mask[q0 + i] : 0.0f;
      sj[u] = i < n ? sigma[q0 + i] : 0.0f;
      kj[u] = i < n ? draw[q0 + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const int i = i0 + u * SCAN_THREADS;
      if (i < n)
        draw[q0 + i] = mj[u] == 0.0f ? 0.0f
                                     : __fmul_rn(__fmul_rn(__fmul_rn(coef[i / k], kj[u]), sj[u]),
                                                 __fsub_rn(1.0f, sj[u]));
    }
  }
}

// (2) as one thread a ray over device memory: the reference the scan above
// is held to bit for bit (fused_step_scan with serial != 0)
__global__ void __launch_bounds__(SERIAL_THREADS)
scan_serial_kernel(const float* __restrict__ sigma, const float* __restrict__ mask,
                   const float* __restrict__ target, long long R, int k, float step, float eps,
                   float g_scale, float* __restrict__ pixel, float* __restrict__ draw) {
  const long long r = (long long)blockIdx.x * SERIAL_THREADS + threadIdx.x;
  if (r >= R) return;
  const float* sg = sigma + r * k;
  const float* mk = mask + r * k;
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

int launch_scan(const float* sigma, const float* mask, const float* target, long long R, int k,
                float step, float eps, float g_scale, float* pixel, float* draw, bool serial,
                cudaStream_t st) {
  if (R <= 0) return (int)cudaSuccess;
  if (serial) {
    scan_serial_kernel<<<(unsigned)((R + SERIAL_THREADS - 1) / SERIAL_THREADS), SERIAL_THREADS,
                         0, st>>>(sigma, mask, target, R, k, step, eps, g_scale, pixel, draw);
  } else {
    scan_kernel<<<(unsigned)((R + SCAN_RAYS - 1) / SCAN_RAYS), SCAN_THREADS, 0, st>>>(
        sigma, mask, target, R, k, step, eps, g_scale, pixel, draw);
  }
  return (int)cudaGetLastError();
}

template <int F>
int launch_step(const GatedMarchX& x, const float* target, long long R, float step, float eps,
                float g_scale, const Params& prm, int nh, float* sigma, float* draw,
                float* pixel, const BwdScratch& s, int n_sms, float* grads, cudaStream_t st) {
  const long long P = R * x.k;
  if (P > 0) {
    // the list of (0) at the start of the dz scratch, [count][tile indices]:
    // ceil(P / 16) + 1 ints, where dz holds (n_hidden + 1) x 16 F bf16 a tile
    int* count = reinterpret_cast<int*>(s.dzs);
    cudaError_t ce = cudaMemsetAsync(count, 0, sizeof(int), st);
    if (ce != cudaSuccess) return (int)ce;
    const long long tiles = (P + TILE - 1) / TILE;
    const long long blocks = (tiles + 32 * LIST_WARPS - 1) / (32 * LIST_WARPS);
    tile_list_kernel<<<(unsigned)blocks, LIST_WARPS * 32, 0, st>>>(x.mask, P, count + 1, count);
    int e = (int)cudaGetLastError();
    if (e != (int)cudaSuccess) return e;
    e = launch_wgmma_march_fwd<F>(x, count + 1, count, P, prm, nh, sigma, n_sms, st);
    if (e != (int)cudaSuccess) return e;
    e = launch_scan(sigma, x.mask, target, R, x.k, step, eps, g_scale, pixel, draw, false, st);
    if (e != (int)cudaSuccess) return e;
  }
  return launch_bwd<F, GatedMarchX>(x, draw, P, prm, nh, DxOut{nullptr, 0, 0}, s, n_sms, grads,
                                    st);
}

}  // namespace

extern "C" {

// sizes the caller allocates by: out[0] dynamic shared memory of the
// chain launch (0 for an unsupported width; the forward's wgmma layout fits
// wherever it does), out[1] floats per chunk partial, out[2] floats in the
// flat gradient, out[3] 8-byte relu-mask slots, out[4] points per
// weight-gradient stage (chunks are multiples)
void fused_step_sizes(int F, int nh, int n_sms, long long* out) {
  out[0] = dims_ok(F, nh) ? (long long)weight_layout(F, nh).total : 0;
  out[1] = (long long)grad_layout(F, nh).stride;
  out[2] = (long long)grad_layout(F, nh).n;
  out[3] = mask_slots(n_sms, nh);
  out[4] = KB;
}

// rows of each layer block of the acts/dzs scratch for P = R k samples (P
// rounded up to whole tiles: the tile-fragment layout)
long long fused_step_scratch_rows(long long P) { return scratch_rows<GatedMarchX>(P); }

// o, d: (R, 3); t_mid, mask: (R, k); target: (R,) f32; R k < 2^31.  sigma,
// draw: (R k,) f32 scratch; pixel: (R,) out; acts, dzs: (nh + 1,
// fused_step_scratch_rows(R k), F) bf16 scratch (dzs also holds the list
// of active tiles); masks, partials, n_chunks, chunk as fused_mlp_bwd;
// grads: the flat gradient (mlp_chain.cuh GradLayout)
int fused_step_grads(const float* o, const float* d, const float* t_mid, const float* mask,
                     const float* target, long long R, int k, float input_scale, float step,
                     float eps, float g_scale, const void* w_in, const void* w_hid,
                     const float* bias, const float* w_out, const float* b_out, int F, int nh,
                     float* sigma, float* draw, float* pixel, void* acts, void* dzs, void* masks,
                     float* partials, int n_chunks, long long chunk, int n_sms, float* grads,
                     void* stream) {
  const BwdScratch s{static_cast<bf16*>(acts), static_cast<bf16*>(dzs),
                     static_cast<uint2*>(masks), partials, n_chunks, chunk};
  if (!dims_ok(F, nh) || R < 0 || k < 1 || n_sms <= 0 || R * k >= (1LL << 31) ||
      !scratch_ok(s, R * k, n_sms))
    return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const GatedMarchX x{{o, d, t_mid, mask, k, input_scale}, draw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, launch_step<FF>(x, target, R, step, eps, g_scale, prm, nh, sigma,
                                          draw, pixel, s, n_sms, grads, st))
}

// launch (2) alone on sigma, mask (R, k) and target (R,): pixel (R,) and
// draw (R, k) out; with serial != 0 the one-thread-a-ray reference
int fused_step_scan(const float* sigma, const float* mask, const float* target, long long R,
                    int k, float step, float eps, float g_scale, float* pixel, float* draw,
                    int serial, void* stream) {
  if (R < 0 || k < 1 || R * k >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return launch_scan(sigma, mask, target, R, k, step, eps, g_scale, pixel, draw, serial != 0,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
