// Fused CPPN-MLP forward and backward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels nerf_for_angiography_tpu/ops/pallas/fused_mlp.py
// ::_fwd_kernel (line 142) and ::_bwd_kernel (line 160), both as
// fused_mlp_raw (P, 3) and as fused_mlp_raw_fm (feature-major) reach them.
//
// The layer chain, its cast points and the kernels live in mlp_chain.cuh,
// shared with fused_step.cu; this file binds them to a strided input: x
// (P, 3) or (3, P) f32 read through its strides, dx written in the same
// layout.
//
// Bound: at F = 128, n_hidden = 4 a point costs 132,096 FLOP forward and
// about three times that backward (recompute + dW + dh), against 16 bytes of
// input/output per point, so every call is compute-bound on the tensor cores
// (989 TFLOP/s bf16 dense).

#include "mlp_chain.cuh"

extern "C" {

// dynamic shared memory of a forward or backward-chain launch (bytes); 0
// for unsupported widths
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

// x: coordinate c of point p at x[p * sp + c * sc]
int fused_mlp_fwd(const float* x, long long sp, long long sc, long long P, const void* w_in,
                  const void* w_hid, const float* bias, const float* w_out, const float* b_out,
                  int F, int nh, float* out, int n_sms, void* stream) {
  if (!dims_ok(F, nh) || n_sms <= 0) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const StridedX xin{x, sp, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, launch_fwd<FF, StridedX, false>(xin, P, prm, nh, out, n_sms, st))
}

// x and dx through the strides (sp, sc); acts, dzs: (nh + 1, P, F) bf16
// scratch; masks: fused_mlp_mask_slots 8-byte slots; partials: n_chunks x
// stride f32; grads: the flat gradient (grad_size floats)
int fused_mlp_bwd(const float* x, long long sp, long long sc, const float* g, long long P,
                  const void* w_in, const void* w_hid, const float* bias, const float* w_out,
                  const float* b_out, int F, int nh, void* acts, void* dzs, void* masks,
                  float* partials, int n_chunks, long long chunk, int n_sms, float* grads,
                  float* dx, void* stream) {
  const BwdScratch s{static_cast<bf16*>(acts), static_cast<bf16*>(dzs),
                     static_cast<uint2*>(masks), partials, n_chunks, chunk};
  if (!dims_ok(F, nh) || !scratch_ok(s, P, n_sms)) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const StridedX xin{x, sp, sc};
  const DxOut dxo{dx, sp, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, launch_bwd<FF, StridedX>(xin, g, P, prm, nh, dxo, s, n_sms, grads, st))
}

}  // extern "C"
