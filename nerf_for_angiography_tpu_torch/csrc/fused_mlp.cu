// Fused CPPN-MLP forward and backward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels nerf_for_angiography_tpu/ops/pallas/fused_mlp.py
// ::_fwd_kernel (line 142) and ::_bwd_kernel (line 160), both as
// fused_mlp_raw (P, 3) and as fused_mlp_raw_fm (feature-major) reach them.
//
// This file binds them to a strided input: x (P, 3) or (3, P) f32 read
// through its strides, dx written in the same layout.  The forward is the
// warpgroup-MMA kernel of mlp_wgmma.cuh (wgmma, 64-point tiles, weights in
// wgmma's shared-memory layouts).  The backward's input is GatedX: it skips
// every 16-point tile whose g is all zero.  At F = 64 and 128 (and the
// depths whose ring of activations fits a block, oc_dims_ok) it is
// mlp_onchip.cuh's on-chip kernel: clusters of one block a hidden layer, the weight gradients of a
// chunk in registers, no activation or dz in device memory.  At the other
// widths it is mlp_chain.cuh's two-kernel backward (the layer chain and its
// cast points, shared with fused_mlp_enc.cu and fused_step.cu), which
// stores its scratch in the tile-fragment layout (mlp_chain.cuh's header).
// Both give the same gradients and dx bit for bit but for the sign of a
// zero.
//
// Bound: at F = 128, n_hidden = 4 a point costs 132,096 FLOP forward and
// about three times that backward (recompute + dW + dh), against 16 bytes of
// input/output per point, so the forward, and the backward that keeps its
// operands on chip, are compute-bound on the tensor cores (989 TFLOP/s
// bf16 dense); the two-kernel backward's scratch round trip (8 (n_hidden +
// 1) F bytes a point of an active tile) makes it bytes-bound.

#include "mlp_chain.cuh"
#include "mlp_onchip.cuh"
#include "mlp_wgmma.cuh"

extern "C" {

// dynamic shared memory of a backward-chain launch (bytes); the forward's
// wgmma layout fits wherever this does; 0 for unsupported widths
long long fused_mlp_smem_bytes(int F, int nh) {
  if (!dims_ok(F, nh)) return 0;
  return (long long)weight_layout(F, nh).total;
}

// floats per chunk partial (the partials buffer holds n_chunks of these)
long long fused_mlp_partial_stride(int F, int nh) { return (long long)grad_layout(F, nh).stride; }

// floats in the flat gradient
long long fused_mlp_grad_size(int F, int nh) { return (long long)grad_layout(F, nh).n; }

// 8-byte relu-mask slots the backward chain needs (one per lane, warp and
// layer of at most n_sms blocks)
long long fused_mlp_mask_slots(int n_sms, int nh) { return mask_slots(n_sms, nh); }

// points per weight-gradient pipeline stage (chunks are multiples of it)
int fused_mlp_chunk_quantum(void) { return KB; }

// x: coordinate c of point p at x[p * sp + c * sc]; the wgmma forward
int fused_mlp_fwd(const float* x, long long sp, long long sc, long long P, const void* w_in,
                  const void* w_hid, const float* bias, const float* w_out, const float* b_out,
                  int F, int nh, float* out, int n_sms, void* stream) {
  if (!dims_ok(F, nh) || n_sms <= 0) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const StridedX xin{x, sp, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, launch_wgmma_fwd<FF>(xin, P, prm, nh, out, n_sms, st))
}

// rows of each layer block of the backward's acts/dzs scratch (P rounded up
// to whole tiles)
long long fused_mlp_scratch_rows(long long P) { return scratch_rows<GatedX>(P); }

// 1 where the backward runs on chip (mlp_onchip.cuh) at this width and
// depth: it then takes no acts, dzs or mask scratch
int fused_mlp_bwd_onchip(int F, int nh) { return oc_dims_ok(F, nh) ? 1 : 0; }

// x and dx through the strides (sp, sc), dx zeroed by the caller (a tile
// whose g is all zero is skipped); acts, dzs: (nh + 1, scratch_rows, F) bf16
// scratch; masks: fused_mlp_mask_slots 8-byte slots (all three unused where
// fused_mlp_bwd_onchip); partials: n_chunks x stride f32; grads: the flat
// gradient (grad_size floats); tiles: a device int64 the backward adds the
// active 16-point tiles it processed into
int fused_mlp_bwd(const float* x, long long sp, long long sc, const float* g, long long P,
                  const void* w_in, const void* w_hid, const float* bias, const float* w_out,
                  const float* b_out, int F, int nh, void* acts, void* dzs, void* masks,
                  float* partials, int n_chunks, long long chunk, int n_sms, float* grads,
                  float* dx, void* tiles, void* stream) {
  const BwdScratch s{static_cast<bf16*>(acts), static_cast<bf16*>(dzs),
                     static_cast<uint2*>(masks), partials, n_chunks, chunk};
  if (!dims_ok(F, nh) || !scratch_ok(s, P, n_sms)) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const DxOut dxo{dx, sp, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GatedX xin{{x, sp, sc}, g};
  unsigned long long* done = static_cast<unsigned long long*>(tiles);
  if (oc_dims_ok(F, nh)) {
    if (F == 64) return launch_onchip_bwd<64, GatedX>(xin, g, P, prm, nh, dxo, s, grads, st, done);
    return launch_onchip_bwd<128, GatedX>(xin, g, P, prm, nh, dxo, s, grads, st, done);
  }
  MLP_CHAIN_DISPATCH_F(F, launch_bwd<FF, GatedX>(xin, g, P, prm, nh, dxo, s, n_sms, grads, st,
                                                 done))
}

}  // extern "C"
