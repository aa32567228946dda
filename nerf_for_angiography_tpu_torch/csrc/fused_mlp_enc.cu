// Fused encoded CPPN-MLP forward and backward for Hopper (sm_90a), bf16
// tensor cores: the fourier / BARF positional encoding formed in the kernel,
// then the layer chain.
//
// Replaces the TPU kernels nerf_for_angiography_tpu/ops/pallas/fused_mlp.py
// ::_fwd_kernel_enc (line 539) and ::_bwd_kernel_enc (line 551), as
// fused_mlp_enc_raw (line 699) reaches them.
//
// The function, at the TPU kernels' cast points: per point x (3 f32
// coordinates, already scaled), v_j = a_j x_{j % 3} (one f32 product; a_j =
// 2 pi coeff_j for fourier, 2^{j / 3} pi for BARF), the encoded features
// [x, sin(v_j) w_j, cos(v_j) w_j] rounded to bf16 (w_j = 1 for fourier, the
// BARF window otherwise), then the relu chain and f32 head of mlp_chain.cuh.
// Backward: the chain's dW/db, then dencw = dz_0 W_in (f32), dv = (cos v, -sin
// v, 1) (dencw w), dx = A^T dv (f32) and, per encoded feature, the sum over
// the points of dv x_c (x in f32) -- the two entries of dA from which the
// caller forms dcoeff_j = 2 pi (dA[sin j] + dA[cos j]) as the JAX package does.
//
// Design: the forward is mlp_wgmma.cuh's wgmma_enc_fwd_kernel (warpgroup
// MMA, 64-point tiles, every weight staged once per block in wgmma's
// layouts); its input is EncX<KE>: each lane forms its own A fragment's
// features in registers from the three coordinates (one sincosf per point
// and band serves the sin and the cos feature: W_in's columns are staged in
// pair order, see EncX), and those registers are the first layer's wgmma A
// operand, so the encoded block never touches shared or device memory in
// the forward.  The backward's chain, its kernels and the fixed-order
// partial sum are mlp_chain.cuh's, and it too forms the features in
// registers (warp_forward).  The backward's input
// is GatedEncX<KE> (BwdX below), as kernel #2's is GatedX: a point is
// active where g != 0, and a 16-point tile with no active point is skipped
// by the chain (no recompute, no sincosf, no stores; dx stays the caller's
// 0 and the tile's dA terms stay 0).  The chain stores its scratch in the
// tile-fragment layout (scratch_rows), and each weight-gradient stage holds
// the chunk's next four active tiles.  The chain also stores each active
// tile's bf16 features, the A fragments its input layer multiplied (P x KE
// bf16: 162 MB at the training shape, beside the 4.3 GB of activations),
// and the weight gradients read them back for dW_in = enc^T dz_0 (forming
// them again there costs that kernel its second block an SM: see
// wgrad_kernel).  The skipped points add exact zeros to every output, so
// the result equals the ungated one bit for bit but for the sign of a
// zero.  The dA terms are summed per lane over its tiles, per warp by
// shuffles in a fixed order, written per (block, warp) by every warp (a
// warp without an active tile writes zeros) and summed in slot order: no
// float atomics, bit-deterministic for a given card.
//
// Bound: at F = 128, n_hidden = 4, E = 3 + 6 L = 33, a point costs 2 (33 F +
// 4 F^2 + F) = 139,776 FLOP forward (0.2385 ms at P = 1,687,500 on 989
// TFLOP/s bf16) and about three times that backward (0.72 ms with every
// point active), against 16 bytes of input/output a point: compute-bound on
// the tensor cores.  The forward reads each layer's B operand from shared
// memory once per 64 points (wgmma), where an mma.sync chain reads it once
// per 16-point warp tile and is paced by shared memory.  The backward's
// scratch round trip (8 (n_hidden + 1) F + 4 KE bytes a point, 2.68 ms at
// that P on 3.35 TB/s) makes it bytes-bound, and both figures scale with
// the active tiles, not with P.
// The kernels do 48 columns of input product where the function needs 33.
// The 15 sincosf a point (forward; the backward chain forms them again, for
// the active tiles, and for dx and dA) run on the CUDA cores: ~45 a point
// in all, ~0.1 ms of FP32 issue at the training shape, small beside the
// tensor work.

#include "mlp_chain.cuh"
#include "mlp_wgmma.cuh"

namespace {

// encoded input widths: KE = 16 ceil((4 + 6 L) / 16), L <= 10
bool enc_dims_ok(int F, int nh, int KE, int n_enc) {
  return dims_ok(F, nh) && (KE == 16 || KE == 32 || KE == 48 || KE == 64) && KE <= F &&
         n_enc >= 0 && 4 + 2 * n_enc <= KE;
}

template <int F, int KE>
int enc_fwd(const EncX<KE>& x, long long P, const Params& prm, int nh, float* out, int n_sms,
            cudaStream_t st) {
  if constexpr (KE > F) {
    return (int)cudaErrorInvalidValue;
  } else {
    return launch_wgmma_enc_fwd<F, KE>(x, P, prm, nh, out, n_sms, st);
  }
}

// the backward's input: gated on g, in the tile-fragment scratch layout
// with active-tile weight-gradient stages and the chain's stored features
// (FRAG = false: row-major scratch, stages skipped only where all four
// tiles are inactive, the features formed again)
constexpr bool ENC_FRAG_SCRATCH = true;
template <int KE>
using BwdX = GatedEncX<KE, ENC_FRAG_SCRATCH>;

template <int F, class X>
int enc_bwd(const X& x, const float* g, long long P, const Params& prm, int nh, const DxOut& dx,
            const BwdScratch& s, int n_sms, float* grads, float* da,
            unsigned long long* tiles_done, cudaStream_t st) {
  if constexpr (X::KI > F) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int e = launch_bwd<F, X>(x, g, P, prm, nh, dx, s, n_sms, grads, st, tiles_done);
    if (e != (int)cudaSuccess) return e;
    // dA: the chain's per-warp sums, in slot order
    const int slots = P > 0 ? bwd_grid(P, n_sms) * BWD_WARPS : 0;
    reduce_partials<<<1, 64, 0, st>>>(dx.da, slots, X::KI, X::KI, da);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// evaluates the expression with the compile-time KE (16, 32, 48, 64) inside
// an F dispatch
#define ENC_DISPATCH_KE(KE, ...)                                \
  switch (KE) {                                                 \
    case 16: { constexpr int KK = 16; return __VA_ARGS__; }     \
    case 32: { constexpr int KK = 32; return __VA_ARGS__; }     \
    case 48: { constexpr int KK = 48; return __VA_ARGS__; }     \
    case 64: { constexpr int KK = 64; return __VA_ARGS__; }     \
  }                                                             \
  return (int)cudaErrorInvalidValue;

template <int F>
int dispatch_fwd(int KE, const StridedX& xs, const float* a, const float* w, int n_enc,
                 long long P, const Params& prm, int nh, float* out, int n_sms,
                 cudaStream_t st) {
  ENC_DISPATCH_KE(KE, enc_fwd<F, KK>(EncX<KK>{xs, a, w, n_enc}, P, prm, nh, out, n_sms, st))
}

template <int F>
int dispatch_bwd(int KE, const StridedX& xs, const float* a, const float* w, int n_enc,
                 const float* g, long long P, const Params& prm, int nh, const DxOut& dx,
                 const BwdScratch& s, bf16* feat, int n_sms, float* grads, float* da,
                 unsigned long long* tiles_done, cudaStream_t st) {
  ENC_DISPATCH_KE(KE, enc_bwd<F>(BwdX<KK>{{xs, a, w, n_enc}, g, feat}, g, P, prm, nh, dx, s,
                                 n_sms, grads, da, tiles_done, st))
}

extern "C" {

// sizes the caller allocates by: out[0] dynamic shared memory of the
// forward or the chain launch, whichever is larger (0 for unsupported
// dimensions), out[1] floats per chunk partial, out[2] floats in the flat
// gradient, out[3] 8-byte relu-mask slots, out[4] points per weight-gradient
// stage (chunks are multiples), out[5] floats of the per-warp dA slots
void fused_mlp_enc_sizes(int F, int nh, int KE, int n_enc, int n_sms, long long* out) {
  const bool ok = enc_dims_ok(F, nh, KE, n_enc);
  out[0] = ok ? (long long)std::max(weight_layout(F, nh, KE).total,
                                     wg_enc_layout(F, nh, KE).total)
              : 0;
  out[1] = ok ? (long long)grad_layout(F, nh, KE).stride : 0;
  out[2] = ok ? (long long)grad_layout(F, nh, KE).n : 0;
  out[3] = mask_slots(n_sms, nh);
  out[4] = KB;
  out[5] = (long long)n_sms * BWD_WARPS * KE;
}

// rows of each layer block of the backward's acts/dzs scratch (P rounded up
// to whole tiles in the tile-fragment layout)
long long fused_mlp_enc_scratch_rows(long long P) { return scratch_rows<BwdX<16>>(P); }

// x: (P, 3) f32; a, w: (n_enc,) f32; w_in: (F, KE) bf16 with its columns in
// EncX's pair order
int fused_mlp_enc_fwd(const float* x, long long P, const float* a, const float* w, int n_enc,
                      int KE, const void* w_in, const void* w_hid, const float* bias,
                      const float* w_out, const float* b_out, int F, int nh, float* out,
                      int n_sms, void* stream) {
  if (!enc_dims_ok(F, nh, KE, n_enc) || n_sms <= 0) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const StridedX xs{x, 3, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, dispatch_fwd<FF>(KE, xs, a, w, n_enc, P, prm, nh, out, n_sms, st))
}

// as fused_mlp_bwd (csrc/fused_mlp.cu) for x (P, 3), acts/dzs of
// fused_mlp_enc_scratch_rows rows a layer, plus: dx (P, 3) f32, zeroed by
// the caller (a tile whose g is all zero is skipped); da_slots: out[5]
// floats of scratch; feat: (fused_mlp_enc_scratch_rows, KE) bf16 scratch
// for the features of the active tiles; da: (KE,) f32 out, dA per
// feature in pair order (entries 2m, 2m + 1 of pair m >= 2: the sin and cos
// rows' sums of dv x_c; the others 0); tiles: a device int64 the chain adds
// the active 16-point tiles it processed into (fused_mlp_bwd's counter)
int fused_mlp_enc_bwd(const float* x, const float* g, long long P, const float* a,
                      const float* w, int n_enc, int KE, const void* w_in, const void* w_hid,
                      const float* bias, const float* w_out, const float* b_out, int F, int nh,
                      void* acts, void* dzs, void* masks, float* partials, int n_chunks,
                      long long chunk, int n_sms, float* grads, float* dx, float* da_slots,
                      float* da, void* feat, void* tiles, void* stream) {
  const BwdScratch s{static_cast<bf16*>(acts), static_cast<bf16*>(dzs),
                     static_cast<uint2*>(masks), partials, n_chunks, chunk};
  if (!enc_dims_ok(F, nh, KE, n_enc) || !scratch_ok(s, P, n_sms) || da_slots == nullptr ||
      feat == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const StridedX xs{x, 3, 1};
  const DxOut dxo{dx, 3, 1, da_slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, dispatch_bwd<FF>(KE, xs, a, w, n_enc, g, P, prm, nh, dxo, s,
                                           static_cast<bf16*>(feat), n_sms, grads, da,
                                           static_cast<unsigned long long*>(tiles), st))
}

}  // extern "C"
