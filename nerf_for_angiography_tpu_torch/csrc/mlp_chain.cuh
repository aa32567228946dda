// The CPPN-MLP layer chain on Hopper (sm_90a) bf16 tensor cores: the pieces
// shared by csrc/fused_mlp.cu (the MLP backward at the widths mlp_onchip.cuh
// does not take, and through mlp_wgmma.cuh and mlp_onchip.cuh the forward
// and the on-chip backward), csrc/fused_mlp_enc.cu (the same over an
// encoded input) and csrc/fused_step.cu (the whole-train-step gradient).
//
// The function: a relu MLP 3 -> F -> (n_hidden x F -> F) -> 1 over P points,
// raw density out; or, with an encoded input (EncX, csrc/fused_mlp_enc.cu),
// the same chain over the fourier / BARF encoding of the 3 coordinates.
// Cast points follow the TPU kernels exactly: x and every
// weight are rounded to bf16 before each product, products accumulate in f32,
// bias + relu run in f32 and the activation is then stored as bf16, the head
// is an f32 dot of the bf16 activation with w_out plus b_out.  In backward,
// dh is rounded to bf16, the relu mask comes from the recomputed bf16
// activations, dW/db accumulate in f32 and dx is f32.
//
// Design (of the two-kernel backward here, which serves kernel #4 and #6's
// backward and kernel #2 at the widths wgmma's 64 rows do not divide, 16-48
// and 80-112; kernel #2 at F = 64 and 128 is mlp_onchip.cuh's, which keeps
// this backward's operands, order and cast points on chip; every forward --
// kernel #1 over a (P, 3) or (3, P) input, #3 over its encoding, #6's over a
// march -- is an mlp_wgmma.cuh warpgroup-MMA kernel built on these pieces,
// and the backward chains recompute the forward through warp_forward):
//  * Every weight of the MLP is staged once per block into shared memory in
//    (out, in) orientation (148 KB at F = 128, n_hidden = 4) and stays there;
//    one persistent block per SM, 8 warps in the backward chain.
//  * Each warp owns 16-point tiles and runs the whole layer chain in
//    registers with mma.sync m16n8k16 (bf16 in, f32 accumulate).  The f32
//    accumulator of one layer has the register layout of the next layer's
//    A operand, so bias + relu + bf16 rounding happen in registers and no
//    activation touches shared memory; B operands come from shared memory by
//    ldmatrix.  No block-level barrier after the weights are staged.
//  * The input layer has K = 3: x is placed in a 16-wide A fragment whose
//    columns 3..15 are zero, and W_in arrives padded to 16 inputs of which
//    3..15 are zero, so the padding adds exact zeros.  Where x comes from is
//    a template parameter: a (P, 3) or (3, P) array read through strides
//    (StridedX), or a march's o + d * t_mid formed in the kernel (MarchX).
//    The input type also fixes the input width KI (X::KI): 16 for the
//    coordinates, KE = 16, 32, 48 or 64 for an encoded input (EncX,
//    GatedEncX), whose features each lane forms in registers (the encoded
//    forward, mlp_wgmma.cuh's, forms them the same way); its backward
//    adds dx through the encode and per-warp sums of dA (no float atomics),
//    and its weight gradients form dW_in's features again from x (EncX) or
//    read the ones its chain stored (GatedEncX).
//  * The ragged edge is masked in the kernel: rows >= P read x = 0 and g = 0
//    and are never stored.
//  * Backward (three launches): (1) per tile, recompute the forward, store
//    each layer's bf16 activation, backpropagate dz through the chain in
//    registers (each lane keeps its relu masks as 64 bits a layer in its
//    warp's slot of device scratch, which stays in cache), store each
//    layer's bf16 dz and, where asked, the f32 dx; (2) the
//    weight gradients dW_l = a_{l-1}^T dz_l as products over the points, one
//    block per (chunk of points, layer), ldmatrix.trans operands streamed
//    through a two-stage cp.async ring, db_l from the same product with an
//    all-ones A operand, dw_out/db_out on the CUDA cores in f32; each block
//    writes its own f32 partial slice; (3) a kernel sums the partials in
//    chunk order.
//    No float atomics: the result is bit-deterministic for a given card (the
//    chunking follows the SM count).  The activations and dz cost
//    2 x (n_hidden + 1) x P x F bf16 of device scratch (4.3 GB at the
//    training shape), allocated by the caller.
//  * Kernels #2 and #4 (the split path's MLP backward, inputs GatedX and,
//    over the encoding, GatedEncX; mlp_onchip.cuh's kernel #2 gates the same
//    way) and #6's backward (GatedMarchX, on the
//    draws its composite scan hands it) work only on tiles that carry a
//    gradient: a point is active where g != 0, and a 16-point tile with no
//    active point is skipped by the chain (no recompute, no sincosf, no
//    stores; dx stays the caller's 0, #4's dA terms stay 0) and by the
//    weight gradients, by the same tile rule: their stages hold the chunk's
//    active tiles only (#4's chain stores those tiles' encoded features for
//    them).  Such points add exact zeros to every gradient, so the
//    result equals the unskipped one bit for bit but for the sign of a
//    zero.  Given a counter (kernels #2 and #4 pass one; #6 passes null),
//    the chain adds the active tiles it processed into it, one atomicAdd a
//    block after a block reduction.  Their chain stores its scratch in
//    the tile-fragment layout (scratch_rows): a warp writes a tile's layer
//    block with 4 F / 16 stores of 128 contiguous bytes (a whole-sector
//    store each, where row-major fragment stores cover half sectors), and
//    the weight gradients read each 16-byte chunk back into its row-major
//    place.  Staging the block in shared memory and writing it with one
//    bulk asynchronous copy (cp.async.bulk) measured no faster than these
//    stores straight from registers.
//  * Bound of this backward at 4 x 128, P = 1,687,500, every point active:
//    0.6757 ms of bf16 tensor-core work.  A design that round-trips the
//    activations and dz through device memory also moves 8 (n_hidden + 1)
//    P F bytes of scratch (written once, read once), 8.64 GB there: a
//    traffic floor of 2.58 ms at 3.35 TB/s, so such a backward is
//    bytes-bound (mlp_onchip.cuh keeps them on chip).  With the skip both
//    figures scale with the active tiles, not with P.
//  * These kernels read every layer's B operand from shared memory once per
//    16-point tile (ldmatrix); mlp_wgmma.cuh's forwards read it once per 64
//    points.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KIN = 16;          // input features (3 coords) padded to one k-step
constexpr int BWD_WARPS = 8;     // backward chain: warps per block (at most 255)
constexpr int TILE = 16;         // points per warp tile
constexpr int KB = 64;           // weight gradients: points per pipeline stage

__host__ __device__ constexpr int ldw(int F) { return F + 8; }  // conflict-free ldmatrix rows
// shared row stride (bf16) of the staged input weight, KI inputs wide
__host__ __device__ constexpr int ldin(int KI) { return KI + 8; }
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// shared-memory carve-up of the backward chain's staged weights
struct WLayout {
  size_t w_in, w_hid, bias, w_out, total;
};

__host__ __device__ inline WLayout weight_layout(int F, int nh, int KI = KIN) {
  WLayout l;
  size_t off = 0;
  l.w_in = off;  off = align16(off + size_t(F) * ldin(KI) * sizeof(bf16));
  l.w_hid = off; off = align16(off + size_t(nh) * F * ldw(F) * sizeof(bf16));
  l.bias = off;  off = align16(off + size_t(nh + 1) * F * sizeof(float));
  l.w_out = off; off = align16(off + size_t(F) * sizeof(float));
  l.total = off;
  return l;
}

// the weight-gradient kernel's ring, g stages, and per-stage bits and list
// (of stages, or for a FRAG_SCRATCH input of tiles) for a chunk of
// ``chunk`` points
template <class X>
__host__ __device__ inline size_t wgrad_smem(int F, long long chunk) {
  const size_t stages = size_t(chunk / KB);
  const size_t items = X::FRAG_SCRATCH ? size_t(chunk / TILE) : stages;
  return 2 * 2 * size_t(KB) * ldw(F) * sizeof(bf16) + 2 * size_t(KB) * sizeof(float) +
         align16(stages) + items * sizeof(int);
}

// flat gradient layout, shared by the per-chunk partials and the result:
// [dW_in (KI x F)][dW_hidden (nh x F x F)][db (nh+1 x F)][dw_out (F)][db_out]
// with every weight gradient in (in, out) orientation
struct GradLayout {
  size_t w_in, w_hid, b, w_out, b_out, n, stride;
};

__host__ __device__ inline GradLayout grad_layout(int F, int nh, int KI = KIN) {
  GradLayout l;
  l.w_in = 0;
  l.w_hid = size_t(KI) * F;
  l.b = l.w_hid + size_t(nh) * F * F;
  l.w_out = l.b + size_t(nh + 1) * F;
  l.b_out = l.w_out + F;
  l.n = l.b_out + 1;
  l.stride = (l.n + 63) & ~size_t(63);  // keeps every chunk's slice 256-byte aligned
  return l;
}

// w_in (F, KI) (for the coordinates KI = KIN, inputs 3..15 zero) and w_hid
// (nh, F, F), both bf16 in (out, in) orientation; bias (nh+1, F), w_out (F,)
// f32, b_out (1,) f32
struct Params {
  const bf16* w_in;
  const bf16* w_hid;
  const float* bias;
  const float* w_out;
  const float* b_out;
};

// ---------------------------------------------------------------------------
// where the input points come from
// ---------------------------------------------------------------------------

// Each input also says which points carry work: a 16-point tile with no
// active point is skipped by the backward chain (nothing is stored for
// it), and the weight-gradient kernel reads it as zeros or leaves it out.

// An input with FRAG_SCRATCH also fixes how the backward stores its scratch,
// in the tile-fragment layout (store_layer below), and the weight-gradient
// kernel fills its stages with the active tiles alone; every other input
// stores it row-major and has the weight gradients read it stage by stage.

// coordinate c of point p at x[p * sp + c * sc]: (P, 3) is sp = 3, sc = 1;
// the feature-major (3, P) is sp = 1, sc = P.  Every point is active (the
// forward kernel #1 computes every point; kernel #2's input is GatedX).
struct StridedX {
  static constexpr int KI = KIN;
  static constexpr bool ENCODED = false;
  static constexpr bool FRAG_SCRATCH = false;
  const float* x;
  long long sp, sc;
  __device__ __forceinline__ float operator()(long long p, int c) const {
    return x[p * sp + c * sc];
  }
  __device__ __forceinline__ bool active(long long) const { return true; }
};

// kernel #2's input: the points of a StridedX, active where the upstream
// gradient g[p] != 0 (-0 counts as zero).  A point with g = 0 has dz = 0 in
// every layer, so it adds exact zeros to every weight gradient and its dx is
// 0: the chain skips a tile with no active point, the weight-gradient kernel
// leaves it out of its stages, and the caller hands in a zeroed dx.
struct GatedX : StridedX {
  static constexpr bool FRAG_SCRATCH = true;
  const float* g;
  __device__ __forceinline__ bool active(long long p) const { return g[p] != 0.0f; }
};

// the sample positions of a rectangular march, formed in the kernel: point
// p = r * k + j is x = (o_r * s) + (d_r * s) * t_mid[r, j], every product
// and sum rounded on its own (no fused multiply-add), as the plain version
// computes it.  A sample with mask 0 adds nothing to the pixel or to the
// gradients (its draw is 0), so only samples with mask != 0 are active:
// kernel #6's forward (mlp_wgmma.cuh's march forward) computes those.
struct MarchX {
  static constexpr int KI = KIN;
  static constexpr bool ENCODED = false;
  static constexpr bool FRAG_SCRATCH = false;
  const float* o;     // (R, 3) origins
  const float* d;     // (R, 3) directions
  const float* tm;    // (R, k) sample midpoints
  const float* mask;  // (R, k) {0, 1}
  int k;
  float s;            // input_scale
  // p < 2^31 (the caller checks R k): a 32-bit division, where a 64-bit
  // one is a call that takes a stack frame
  __device__ __forceinline__ float operator()(long long p, int c) const {
    const unsigned r = unsigned(p) / unsigned(k);
    const float oc = __fmul_rn(o[r * 3 + c], s), dc = __fmul_rn(d[r * 3 + c], s);
    return __fadd_rn(oc, __fmul_rn(dc, tm[p]));
  }
  __device__ __forceinline__ bool active(long long p) const { return mask[p] != 0.0f; }
};

// kernel #6's backward input: the samples of a MarchX, active where the
// draw (the gradient the composite hands the MLP) is not zero (-0 counts as
// zero), as GatedX gates kernel #2's on g.  A sample with draw 0 has dz = 0
// in every layer and adds exact zeros to every gradient: masked samples,
// samples after the early stop (keep 0) and those with sigma (1 - sigma) =
// 0, so this gate skips at least what the mask gate skips.  The chain skips
// a tile with no active sample, the weight-gradient stages hold the active
// tiles only, and the scratch is stored in the tile-fragment layout.
struct GatedMarchX : MarchX {
  static constexpr bool FRAG_SCRATCH = true;
  const float* draw;  // (R, k)
  __device__ __forceinline__ bool active(long long p) const { return draw[p] != 0.0f; }
};

// warp-collective: does the 16-point tile at p0 hold an active point (< P)?
template <class X>
__device__ __forceinline__ bool tile_active(const X& x, long long p0, long long P) {
  const int lane = threadIdx.x & 31;
  const long long p = p0 + (lane & 15);
  return __any_sync(0xffffffffu, lane < 16 && p < P && x.active(p));
}

// an encoded input: the coordinates of a (P, 3) or (3, P) array (read as
// StridedX reads them) through the fourier / BARF positional encoding,
// formed in the kernel.  Its KE features come in pairs (2m, 2m + 1), one
// pair to one register of an A fragment:
//   pair 0 = (x0, x1), pair 1 = (x2, 0),
//   pair 2 + j = (sin(v_j) w_j, cos(v_j) w_j) with v_j = a_j x_{j % 3} (one
//     f32 product), j < n_enc = 3 L,
//   every later pair (0, 0);
// each rounded to bf16 where it enters the product.  The JAX order [x, sin
// rows, cos rows] is this one permuted: the caller stages W_in's columns in
// this order, so one sincosf serves a point's sin and cos feature of band j.
// sincosf is the full-precision one: |v| reaches ~100 rad (fourier
// coefficients at 3 sigma of 5, times 2 pi), where __sinf is far off.
// Every point is active (the forward, kernel #3, computes every point;
// kernel #4's input is GatedEncX).
template <int KE>
struct EncX {
  static constexpr int KI = KE;
  static constexpr bool ENCODED = true;
  static constexpr bool FRAG_SCRATCH = false;
  StridedX xs;
  const float* a;  // (n_enc,) a_j
  const float* w;  // (n_enc,) w_j
  int n_enc;
  __device__ __forceinline__ float operator()(long long p, int c) const { return xs(p, c); }
  __device__ __forceinline__ bool active(long long) const { return true; }
  __device__ __forceinline__ float3 coords(long long p) const {
    return make_float3(xs(p, 0), xs(p, 1), xs(p, 2));
  }
  static __device__ __forceinline__ float coord(const float3& c, int i) {
    return i == 0 ? c.x : (i == 1 ? c.y : c.z);
  }
  // the f32 features of pair m of a point at coordinates c
  __device__ __forceinline__ float2 pair(const float3& c, int m) const {
    if (m == 0) return make_float2(c.x, c.y);
    if (m == 1) return make_float2(c.z, 0.0f);
    const int j = m - 2;
    if (j >= n_enc) return make_float2(0.0f, 0.0f);
    float s, co;
    sincosf(__fmul_rn(a[j], coord(c, j % 3)), &s, &co);
    const float wj = w[j];
    return make_float2(__fmul_rn(s, wj), __fmul_rn(co, wj));
  }
  // backward of pair m for (d0, d1) = dL/d(its two features) in f32: adds
  // dL/dx to (dx0, dx1, dx2) and returns the pair's two dA terms
  // (dv_sin x_c, dv_cos x_c), c = j % 3, with x in f32
  __device__ __forceinline__ float2 pair_backward(const float3& c, int m, float d0, float d1,
                                                  float& dx0, float& dx1, float& dx2) const {
    if (m == 0) {
      dx0 += d0;
      dx1 += d1;
      return make_float2(0.0f, 0.0f);
    }
    if (m == 1) {
      dx2 += d0;
      return make_float2(0.0f, 0.0f);
    }
    const int j = m - 2;
    if (j >= n_enc) return make_float2(0.0f, 0.0f);
    const int ci = j % 3;
    const float xc = coord(c, ci), aj = a[j], wj = w[j];
    float s, co;
    sincosf(__fmul_rn(aj, xc), &s, &co);
    const float dvs = __fmul_rn(co, __fmul_rn(d0, wj));   // sin row: cos(v) (dencw w)
    const float dvc = __fmul_rn(-s, __fmul_rn(d1, wj));   // cos row: -sin(v) (dencw w)
    const float dxc = __fadd_rn(__fmul_rn(aj, dvs), __fmul_rn(aj, dvc));
    if (ci == 0) dx0 += dxc;
    else if (ci == 1) dx1 += dxc;
    else dx2 += dxc;
    return make_float2(__fmul_rn(dvs, xc), __fmul_rn(dvc, xc));
  }
};

// kernel #4's input: the points of an EncX, active where the upstream
// gradient g[p] != 0 (-0 counts as zero), as GatedX gates kernel #2's.  A
// point with g = 0 has dz = 0 in every layer and adds exact zeros to every
// weight gradient, to dA and to dx: the chain skips a tile with no active
// point, the weight-gradient kernel leaves it out, and the caller hands in
// a zeroed dx.  FRAG picks the scratch layout (FRAG_SCRATCH above);
// csrc/fused_mlp_enc.cu ships one.  With FRAG the chain also stores each
// active tile's bf16 features (the A fragments of its input layer) to
// feat, scratch_rows x KE in the tile-fragment layout, and the weight
// gradients read them back for dW_in; without it they form them again.
template <int KE, bool FRAG>
struct GatedEncX : EncX<KE> {
  static constexpr bool FRAG_SCRATCH = FRAG;
  const float* g;
  bf16* feat;
  __device__ __forceinline__ bool active(long long p) const { return g[p] != 0.0f; }
};

// where the backward chain writes dx (dx == nullptr: not at all) and, for
// an encoded input, each warp's KI sums of dA (per pair, the sin and cos
// row's sum of dv x_c over the warp's points) at da[(block * BWD_WARPS +
// warp) * KI]
struct DxOut {
  float* dx;
  long long sp, sc;
  float* da = nullptr;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) @ b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// two floats -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// ---------------------------------------------------------------------------
// warp-level pieces.  Fragment layouts of m16n8k16 (g = lane / 4,
// t = lane % 4): A register q holds row g + 8 * (q & 1), columns
// 8 * (q >> 1) + 2t, +1; C register pair (0,1) holds row g, (2,3) row g + 8,
// columns 2t, 2t+1.  So C n-tiles 2j, 2j+1 are the A fragment of k-step j.
// ---------------------------------------------------------------------------

// acc (16 x 8NT) = A (16 x 16KT, fragments) @ W^T, W (rows = out, cols = in)
// in shared memory with row stride ld
template <int KT, int NT>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                        const bf16* w, int ld) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, w + (np * 16 + (mi >> 1) * 8 + r) * ld + kt * 16 + (mi & 1) * 8);
      mma(acc[2 * np], a[kt], b[0], b[1]);
      mma(acc[2 * np + 1], a[kt], b[2], b[3]);
    }
  }
}

// acc (16 x 8NT) = A (16 x 16KT, fragments) @ W, W as in warp_mm (the
// backward product through a layer: K runs over W's rows)
template <int KT, int NT>
__device__ __forceinline__ void warp_mm_t(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                          const bf16* w, int ld) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, w + (kt * 16 + (mi & 1) * 8 + r) * ld + np * 16 + (mi >> 1) * 8);
      mma(acc[2 * np], a[kt], b[0], b[1]);
      mma(acc[2 * np + 1], a[kt], b[2], b[3]);
    }
  }
}

// a = bf16(relu(acc + bias)), f32 epilogue, into A-fragment registers
template <int F>
__device__ __forceinline__ void bias_relu_pack(uint32_t (&a)[F / 16][4],
                                               const float (&acc)[F / 8][4],
                                               const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < F / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    a[nt >> 1][(nt & 1) * 2] = pack2(fmaxf(acc[nt][0] + b0, 0.0f), fmaxf(acc[nt][1] + b1, 0.0f));
    a[nt >> 1][(nt & 1) * 2 + 1] =
        pack2(fmaxf(acc[nt][2] + b0, 0.0f), fmaxf(acc[nt][3] + b1, 0.0f));
  }
}

// store a tile's A fragments to a (P x F) bf16 row-major array, rows < P
template <int F>
__device__ __forceinline__ void store_frag(bf16* dst, const uint32_t (&a)[F / 16][4],
                                           long long p0, long long P) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long r0 = p0 + g, r1 = r0 + 8;
#pragma unroll
  for (int kt = 0; kt < F / 16; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = kt * 16 + h * 8 + 2 * t;
      if (r0 < P) *reinterpret_cast<uint32_t*>(dst + r0 * F + c) = a[kt][h * 2];
      if (r1 < P) *reinterpret_cast<uint32_t*>(dst + r1 * F + c) = a[kt][h * 2 + 1];
    }
  }
}

// The tile-fragment layout of a FRAG_SCRATCH input's scratch: layer blocks of
// scratch_rows(P) rows (P rounded up to whole tiles); the tile at p0 is the
// contiguous 16 x F bf16 block at row p0, in which 32-bit word
// (4 kt + q) * 32 + lane holds that lane's A-fragment register a[kt][q].  So
// its 16-byte chunk (4 kt + q) * 8 + g is row g + 8 (q & 1), columns
// 16 kt + 8 (q >> 1) .. + 7 in order, and a warp writes a whole tile with
// 4 F / 16 stores of 128 contiguous bytes.
template <class X>
__host__ __device__ inline long long scratch_rows(long long P) {
  return X::FRAG_SCRATCH ? (P + TILE - 1) / TILE * TILE : P;
}

// store a tile's A fragments to its block of a layer's scratch: row-major
// with store_frag, or (X::FRAG_SCRATCH) in the tile-fragment layout
template <int F, class X>
__device__ __forceinline__ void store_layer(bf16* layer, const uint32_t (&a)[F / 16][4],
                                            long long p0, long long P) {
  if constexpr (X::FRAG_SCRATCH) {
    uint32_t* d = reinterpret_cast<uint32_t*>(layer + size_t(p0) * F) + (threadIdx.x & 31);
#pragma unroll
    for (int i = 0; i < F / 4; ++i) d[i * 32] = a[i >> 2][i & 3];
  } else {
    store_frag<F>(layer, a, p0, P);
  }
}

template <int KI>
__device__ void stage_weights(unsigned char* smem, const WLayout& L, const Params& prm, int F,
                              int nh) {
  bf16* win = reinterpret_cast<bf16*>(smem + L.w_in);
  constexpr int VI = KI / 8;  // 16-byte vectors per input-weight row
  for (int i = threadIdx.x; i < F * VI; i += blockDim.x) {
    const int r = i / VI, c = (i % VI) * 8;
    *reinterpret_cast<uint4*>(win + r * ldin(KI) + c) =
        *reinterpret_cast<const uint4*>(prm.w_in + r * KI + c);
  }
  bf16* wh = reinterpret_cast<bf16*>(smem + L.w_hid);
  const int vec = F / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < nh * F * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    *reinterpret_cast<uint4*>(wh + size_t(r) * ldw(F) + c) =
        *reinterpret_cast<const uint4*>(prm.w_hid + size_t(r) * F + c);
  }
  float* b = reinterpret_cast<float*>(smem + L.bias);
  for (int i = threadIdx.x; i < (nh + 1) * F; i += blockDim.x) b[i] = prm.bias[i];
  float* wo = reinterpret_cast<float*>(smem + L.w_out);
  for (int i = threadIdx.x; i < F; i += blockDim.x) wo[i] = prm.w_out[i];
}

// this lane's relu mask of a layer: bit 4 nt + e is set where element e of
// C n-tile nt (e = 0, 1: row g, columns 2t, 2t+1; e = 2, 3: row g + 8) of
// the bf16 activation is > 0
template <int F>
__device__ __forceinline__ uint2 relu_mask(const uint32_t (&a)[F / 16][4]) {
  uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
  for (int nt = 0; nt < F / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = unpack2(a[nt >> 1][(nt & 1) * 2 + half]);
      const uint32_t bits = (v.x > 0.0f ? 1u : 0u) | (v.y > 0.0f ? 2u : 0u);
      const int b = 4 * nt + 2 * half;
      if (b < 32) w0 |= bits << b;
      else w1 |= bits << (b - 32);
    }
  }
  return make_uint2(w0, w1);
}

// the forward chain of one 16-point tile; a ends as the last activation.
// With acts != nullptr every layer's activation is stored to acts[l]
// (scratch_rows(P) x F bf16, by store_layer) and this lane's relu mask of
// it to masks[32 l].
template <int F, class X>
__device__ __forceinline__ void warp_forward(uint32_t (&a)[F / 16][4], const X& x,
                                             long long p0, long long P,
                                             const unsigned char* smem, const WLayout& L,
                                             int nh, bf16* acts, uint2* masks) {
  const long long PS = scratch_rows<X>(P);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long r0 = p0 + g, r1 = r0 + 8;
  constexpr int KT = X::KI / 16;
  uint32_t ax[KT][4];
  if constexpr (X::ENCODED) {
    // register q of k-step kt holds row g + 8 (q & 1), pair 8 kt + 4 (q >> 1) + t
    const float3 zero = make_float3(0.0f, 0.0f, 0.0f);
    const float3 c0 = r0 < P ? x.coords(r0) : zero, c1 = r1 < P ? x.coords(r1) : zero;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * kt + 4 * h + t;
        const float2 u0 = x.pair(c0, m), u1 = x.pair(c1, m);
        ax[kt][2 * h] = pack2(u0.x, u0.y);
        ax[kt][2 * h + 1] = pack2(u1.x, u1.y);
      }
    }
    if constexpr (X::FRAG_SCRATCH) {
      // kernel #4's chain: the tile's features for the weight gradients'
      // dW_in, in the tile-fragment layout (store_layer's, KI wide)
      if (acts) {
        uint32_t* d = reinterpret_cast<uint32_t*>(x.feat + size_t(p0) * X::KI) + lane;
#pragma unroll
        for (int i = 0; i < KT * 4; ++i) d[i * 32] = ax[i >> 2][i & 3];
      }
    }
  } else {
    // A fragment of x: thread t = 0 holds columns 0, 1; t = 1 holds 2 (and a zero 3)
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
    if (t < 2) {
      if (r0 < P) {
        v0 = x(r0, 2 * t);
        if (t == 0) v1 = x(r0, 1);
      }
      if (r1 < P) {
        v2 = x(r1, 2 * t);
        if (t == 0) v3 = x(r1, 1);
      }
    }
    ax[0][0] = pack2(v0, v1);
    ax[0][1] = pack2(v2, v3);
    ax[0][2] = ax[0][3] = 0u;
  }
  const float* bias = reinterpret_cast<const float*>(smem + L.bias);
  float acc[F / 8][4];
  warp_mm<KT, F / 8>(acc, ax, reinterpret_cast<const bf16*>(smem + L.w_in), ldin(X::KI));
  bias_relu_pack<F>(a, acc, bias);
  if (acts) {
    store_layer<F, X>(acts, a, p0, P);
    masks[0] = relu_mask<F>(a);
  }
  const bf16* wh = reinterpret_cast<const bf16*>(smem + L.w_hid);
  for (int l = 0; l < nh; ++l) {
    warp_mm<F / 16, F / 8>(acc, a, wh + size_t(l) * F * ldw(F), ldw(F));
    bias_relu_pack<F>(a, acc, bias + (l + 1) * F);
    if (acts) {
      store_layer<F, X>(acts + size_t(l + 1) * PS * F, a, p0, P);
      masks[32 * (l + 1)] = relu_mask<F>(a);
    }
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// backward, part 1: recompute, store activations, backpropagate dz, dx
// (and, for an encoded input, each warp's dA sums)
template <int F, class X>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
bwd_chain_kernel(X x, const float* __restrict__ gr, long long P, Params prm, int nh,
                 bf16* __restrict__ acts, bf16* __restrict__ dzs, DxOut dx,
                 uint2* __restrict__ mask_slots, unsigned long long* __restrict__ tiles_done) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WLayout L = weight_layout(F, nh, X::KI);
  stage_weights<X::KI>(smem, L, prm, F, nh);
  __syncthreads();
  const long long PS = scratch_rows<X>(P);
  // encoded input: this lane's running dA terms of its pairs 4 nt + t
  constexpr int NE = X::ENCODED ? X::KI / 8 : 1;
  float da[NE][2];
#pragma unroll
  for (int nt = 0; nt < NE; ++nt) da[nt][0] = da[nt][1] = 0.0f;
  const float* wo = reinterpret_cast<const float*>(smem + L.w_out);
  const bf16* wh = reinterpret_cast<const bf16*>(smem + L.w_hid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint2* masks = mask_slots + (size_t(blockIdx.x) * BWD_WARPS + warp) * (nh + 1) * 32 + lane;
  const long long n_tiles = (P + TILE - 1) / TILE;
  unsigned int n_active = 0;  // the warp's active tiles (the same in every lane)
  for (long long tile = (long long)blockIdx.x * BWD_WARPS + warp; tile < n_tiles;
       tile += (long long)gridDim.x * BWD_WARPS) {
    const long long p0 = tile * TILE;
    if (!tile_active(x, p0, P)) continue;  // the weight gradients skip it too
    ++n_active;
    const long long r0 = p0 + g, r1 = r0 + 8;
    uint32_t a[F / 16][4];
    warp_forward<F>(a, x, p0, P, smem, L, nh, acts, masks);

    // head: dz = bf16(w_out * g) where the last activation is > 0
    const float g0 = r0 < P ? gr[r0] : 0.0f, g1 = r1 < P ? gr[r1] : 0.0f;
#pragma unroll
    for (int kt = 0; kt < F / 16; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kt * 16 + h * 8 + 2 * t;
        const float2 u0 = unpack2(a[kt][h * 2]), u1 = unpack2(a[kt][h * 2 + 1]);
        a[kt][h * 2] = pack2(u0.x > 0.0f ? wo[c] * g0 : 0.0f, u0.y > 0.0f ? wo[c + 1] * g0 : 0.0f);
        a[kt][h * 2 + 1] =
            pack2(u1.x > 0.0f ? wo[c] * g1 : 0.0f, u1.y > 0.0f ? wo[c + 1] * g1 : 0.0f);
      }
    }
    store_layer<F, X>(dzs + size_t(nh) * PS * F, a, p0, P);

    // hidden layers in reverse: dz_{l-1} = bf16(dz_l @ W_l) where a_{l-1} > 0
    for (int l = nh; l >= 1; --l) {
      float acc[F / 8][4];
      warp_mm_t<F / 16, F / 8>(acc, a, wh + size_t(l - 1) * F * ldw(F), ldw(F));
      const uint2 m = masks[32 * (l - 1)];  // relu mask of a_{l-1}
#pragma unroll
      for (int nt = 0; nt < F / 8; ++nt) {
        const uint32_t bits = (4 * nt < 32 ? m.x : m.y) >> ((4 * nt) & 31);
        a[nt >> 1][(nt & 1) * 2] =
            pack2((bits & 1u) ? acc[nt][0] : 0.0f, (bits & 2u) ? acc[nt][1] : 0.0f);
        a[nt >> 1][(nt & 1) * 2 + 1] =
            pack2((bits & 4u) ? acc[nt][2] : 0.0f, (bits & 8u) ? acc[nt][3] : 0.0f);
      }
      store_layer<F, X>(dzs + size_t(l - 1) * PS * F, a, p0, P);
    }

    if constexpr (X::ENCODED) {
      // dencw = dz_0 @ W_in (f32, KI columns): C n-tile nt holds pair
      // 4 nt + t, rows g (registers 0, 1) and g + 8 (2, 3); back through the
      // encode to dx (summed over the four lanes of a row) and dA
      float acce[NE][4];
      warp_mm_t<F / 16, NE>(acce, a, reinterpret_cast<const bf16*>(smem + L.w_in),
                            ldin(X::KI));
      const float3 zero = make_float3(0.0f, 0.0f, 0.0f);
      const float3 c0 = r0 < P ? x.coords(r0) : zero, c1 = r1 < P ? x.coords(r1) : zero;
      float d0[3] = {0.0f, 0.0f, 0.0f}, d1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < NE; ++nt) {
        const int m = 4 * nt + t;
        const float2 e0 = x.pair_backward(c0, m, acce[nt][0], acce[nt][1], d0[0], d0[1], d0[2]);
        const float2 e1 = x.pair_backward(c1, m, acce[nt][2], acce[nt][3], d1[0], d1[1], d1[2]);
        da[nt][0] += e0.x + e1.x;
        da[nt][1] += e0.y + e1.y;
      }
      if (dx.dx) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          d0[i] += __shfl_xor_sync(0xffffffffu, d0[i], 1);
          d0[i] += __shfl_xor_sync(0xffffffffu, d0[i], 2);
          d1[i] += __shfl_xor_sync(0xffffffffu, d1[i], 1);
          d1[i] += __shfl_xor_sync(0xffffffffu, d1[i], 2);
        }
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            if (r0 < P) dx.dx[r0 * dx.sp + i * dx.sc] = d0[i];
            if (r1 < P) dx.dx[r1 * dx.sp + i * dx.sc] = d1[i];
          }
        }
      }
    } else if (dx.dx) {
      // dx = dz_0 @ W_in (f32); columns 0..2 are the coordinates
      float accx[2][4];
      warp_mm_t<F / 16, 2>(accx, a, reinterpret_cast<const bf16*>(smem + L.w_in), ldin(KIN));
      if (t < 2) {
        if (r0 < P) {
          dx.dx[r0 * dx.sp + 2 * t * dx.sc] = accx[0][0];
          if (t == 0) dx.dx[r0 * dx.sp + dx.sc] = accx[0][1];
        }
        if (r1 < P) {
          dx.dx[r1 * dx.sp + 2 * t * dx.sc] = accx[0][2];
          if (t == 0) dx.dx[r1 * dx.sp + dx.sc] = accx[0][3];
        }
      }
    }
  }
  if constexpr (X::ENCODED) {
    // the warp's sums: over the eight lanes (g) of each pair, in a fixed order
#pragma unroll
    for (int nt = 0; nt < NE; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = da[nt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        da[nt][e] = v;
      }
    }
    if (g == 0 && dx.da) {
      float* slot = dx.da + (size_t(blockIdx.x) * BWD_WARPS + warp) * X::KI;
#pragma unroll
      for (int nt = 0; nt < NE; ++nt) {
        slot[2 * (4 * nt + t)] = da[nt][0];
        slot[2 * (4 * nt + t) + 1] = da[nt][1];
      }
    }
  }
  if (tiles_done) {
    // the block's sum of its warps' counts, in the weights' shared memory
    // (every warp is past its last read of them)
    unsigned int* warp_tiles = reinterpret_cast<unsigned int*>(smem);
    __syncthreads();
    if (lane == 0) warp_tiles[warp] = n_active;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long sum = 0;
      for (int w = 0; w < BWD_WARPS; ++w) sum += warp_tiles[w];
      atomicAdd(tiles_done, sum);
    }
  }
}

// backward, part 2: one block per (chunk of points, job).  Job l <= nh:
// dW_l = A_l^T dz_l (A_0 = bf16(x) padded to 16 columns, or the encoded
// input's KI features, formed again from x or read back from the chain's
// feat; A_l = a_{l-1}) and
// db_l = 1^T dz_l; job nh + 1: dw_out = a_nh^T g, db_out = sum g in f32.
// Warp w < M/16 owns rows 16w.. of dW_l; the last warp computes db_l.
// Stages of KB points with no active tile are skipped; inside a stage the
// rows of an inactive tile (never stored by the chain) load as zeros.  For
// a FRAG_SCRATCH input a stage is instead made of the chunk's next KB / TILE
// active tiles, so no inactive tile is multiplied: the active tiles meet
// the accumulators in the same order and an inactive one added exact
// zeros, so the result is the same bit for bit but for the sign of a zero.
// An encoded FRAG_SCRATCH input's job 0 reads the features its chain
// stored: forming them here again (15 sincosf a point) took this kernel
// from 96 to 125 registers at F = 128, and two blocks of nine warps fit an
// SM only at <= 96 (a two-block launch bound made it spill).
template <int F, class X>
__global__ void __launch_bounds__(32 * (F / 16 + 1))
wgrad_kernel(X x, const float* __restrict__ gr, const bf16* __restrict__ acts,
             const bf16* __restrict__ dzs, long long P, int nh, long long chunk,
             float* __restrict__ partials, long long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = F + 8;
  constexpr int NWARPS = F / 16 + 1;
  constexpr int TPS = KB / TILE;  // tiles a stage
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * KB * LD;
  float* gs = reinterpret_cast<float*>(Bs + 2 * KB * LD);
  const int max_stages = (int)(chunk / KB);
  // per stage of the chunk: bit t set where its tile t holds an active
  // point; then the list of stages with any (FRAG_SCRATCH: of the active
  // tiles, as tile indices in the chunk)
  uint8_t* stage_bits = reinterpret_cast<uint8_t*>(gs + 2 * KB);
  int* stage_list = reinterpret_cast<int*>(stage_bits + align16(max_stages));
  __shared__ int n_active;
  const int job = blockIdx.y;
  const bool head = job == nh + 1;
  const long long p_lo = (long long)blockIdx.x * chunk;
  const long long p_hi = p_lo + chunk < P ? p_lo + chunk : P;
  const int n_stages = p_hi > p_lo ? (int)((p_hi - p_lo + KB - 1) / KB) : 0;
  const long long PS = scratch_rows<X>(P);
  const bf16* bsrc = head ? acts + size_t(nh) * PS * F : dzs + size_t(job) * PS * F;
  const bf16* asrc = (!head && job >= 1) ? acts + size_t(job - 1) * PS * F : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, r = lane & 7;
  const int m_tiles = job == 0 ? X::KI / 16 : F / 16;
  const bool ones_warp = warp == F / 16;

  for (int st = warp; st < n_stages; st += NWARPS) {
    uint32_t bits = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = p_lo + (long long)st * KB + h * 32 + lane;
      const uint32_t v = __ballot_sync(0xffffffffu, p < p_hi && x.active(p));
      bits |= ((v & 0xFFFFu) ? 1u : 0u) << (2 * h);
      bits |= ((v >> 16) ? 1u : 0u) << (2 * h + 1);
    }
    if (lane == 0) stage_bits[st] = (uint8_t)bits;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int st = 0; st < n_stages; ++st) {
      if constexpr (X::FRAG_SCRATCH) {
        for (uint32_t b = stage_bits[st]; b; b &= b - 1u)
          stage_list[n++] = st * TPS + __ffs((int)b) - 1;
      } else {
        if (stage_bits[st]) stage_list[n++] = st;
      }
    }
    n_active = n;
  }
  __syncthreads();
  const int n_k = X::FRAG_SCRATCH ? (n_active + TPS - 1) / TPS : n_active;

  // stage s of the ring <- the kk-th active stage of the chunk (FRAG_SCRATCH:
  // its active tiles TPS kk .. TPS kk + TPS - 1)
  auto load = [&](int s, int kk) {
    constexpr int VEC = F / 8;
    if constexpr (X::FRAG_SCRATCH) {
      // the first point of the stage's tile tt; p_hi where the chunk has no
      // more active tiles, so that the tile's rows load as zeros
      auto tile_p0 = [&](int tt) {
        const int j = kk * TPS + tt;
        return j < n_active ? p_lo + (long long)stage_list[j] * TILE : p_hi;
      };
      for (int i = threadIdx.x; i < KB * VEC; i += blockDim.x) {
        // consecutive threads read consecutive chunks of the tile-fragment
        // layout (chunk ch of tile tt) into their row-major place
        const int tt = i / (2 * F), ch = i % (2 * F);
        const int rt = (ch & 7) + 8 * ((ch >> 3) & 1);
        const int row = tt * TILE + rt;
        const int c = (ch >> 5) * 16 + 8 * ((ch >> 4) & 1);
        const long long t0 = tile_p0(tt);
        const bool in = t0 + rt < p_hi;
        const size_t off = in ? size_t(t0) * F + size_t(ch) * 8 : size_t(p_lo) * F;
        cp_async16(Bs + (s * KB + row) * LD + c, bsrc + off, in ? 16 : 0);
        if (asrc) cp_async16(As + (s * KB + row) * LD + c, asrc + off, in ? 16 : 0);
      }
      if (!head && job == 0) {
        if constexpr (X::ENCODED) {
          // the features the chain stored for the active tiles, KI wide,
          // each 16-byte chunk into its row-major place as above
          for (int i = threadIdx.x; i < KB * X::KI / 8; i += blockDim.x) {
            const int tt = i / (2 * X::KI), ch = i % (2 * X::KI);
            const int rt = (ch & 7) + 8 * ((ch >> 3) & 1);
            const int c = (ch >> 5) * 16 + 8 * ((ch >> 4) & 1);
            const long long t0 = tile_p0(tt);
            const bool in = t0 + rt < p_hi;
            const size_t off =
                in ? size_t(t0) * X::KI + size_t(ch) * 8 : size_t(p_lo) * X::KI;
            cp_async16(As + (s * KB + tt * TILE + rt) * LD + c, x.feat + off, in ? 16 : 0);
          }
        } else {
          for (int i = threadIdx.x; i < KB * KIN; i += blockDim.x) {
            const int row = i / KIN, c = i % KIN;
            const long long p = tile_p0(row / TILE) + row % TILE;
            As[(s * KB + row) * LD + c] = __float2bfloat16_rn(c < 3 && p < p_hi ? x(p, c) : 0.0f);
          }
        }
      }
      if (head) {
        for (int i = threadIdx.x; i < KB; i += blockDim.x) {
          const long long p = tile_p0(i / TILE) + i % TILE;
          gs[s * KB + i] = p < p_hi ? gr[p] : 0.0f;
        }
      }
      return;
    }
    const int st = stage_list[kk];
    const long long kb = p_lo + (long long)st * KB;
    const uint32_t bits = stage_bits[st];
    for (int i = threadIdx.x; i < KB * VEC; i += blockDim.x) {
      const int row = i / VEC, c = (i % VEC) * 8;
      const long long p = kb + row;
      const bool in = p < p_hi && ((bits >> (row / TILE)) & 1u);
      const size_t off = size_t(in ? p : p_lo) * F + c;
      cp_async16(Bs + (s * KB + row) * LD + c, bsrc + off, in ? 16 : 0);
      if (asrc) cp_async16(As + (s * KB + row) * LD + c, asrc + off, in ? 16 : 0);
    }
    if (!head && job == 0) {
      if constexpr (X::ENCODED) {
        constexpr int NP = X::KI / 2;  // feature pairs a point
        for (int i = threadIdx.x; i < KB * NP; i += blockDim.x) {
          const int row = i / NP, m = i % NP;
          const long long p = kb + row;
          uint32_t v = 0u;
          if (p < p_hi) {
            const float2 u = x.pair(x.coords(p), m);
            v = pack2(u.x, u.y);
          }
          *reinterpret_cast<uint32_t*>(As + (s * KB + row) * LD + 2 * m) = v;
        }
      } else {
        for (int i = threadIdx.x; i < KB * KIN; i += blockDim.x) {
          const int row = i / KIN, c = i % KIN;
          const long long p = kb + row;
          As[(s * KB + row) * LD + c] = __float2bfloat16_rn(c < 3 && p < p_hi ? x(p, c) : 0.0f);
        }
      }
    }
    if (head) {
      for (int i = threadIdx.x; i < KB; i += blockDim.x) {
        const long long p = kb + i;
        gs[s * KB + i] = p < p_hi ? gr[p] : 0.0f;
      }
    }
  };

  float acc[F / 8][4];
#pragma unroll
  for (int nt = 0; nt < F / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float hs = 0.0f;

  if (n_k > 0) load(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_k; ++k) {
    const int s = k & 1;
    if (k + 1 < n_k) load(s ^ 1, k + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* A = As + s * KB * LD;
    const bf16* B = Bs + s * KB * LD;
    if (head) {
      if (threadIdx.x < F) {
        for (int p = 0; p < KB; ++p)
          hs += __bfloat162float(B[p * LD + threadIdx.x]) * gs[s * KB + p];
      } else if (threadIdx.x == F) {
        for (int p = 0; p < KB; ++p) hs += gs[s * KB + p];
      }
    } else if (warp < m_tiles || ones_warp) {
#pragma unroll
      for (int kt = 0; kt < KB / 16; ++kt) {
        uint32_t af[4];
        if (ones_warp) {
          af[0] = af[1] = af[2] = af[3] = 0x3F803F80u;  // bf16 1.0 pairs
        } else {
          ldsm_x4_t(af, A + (kt * 16 + (mi >> 1) * 8 + r) * LD + warp * 16 + (mi & 1) * 8);
        }
#pragma unroll
        for (int np = 0; np < F / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, B + (kt * 16 + (mi & 1) * 8 + r) * LD + np * 16 + (mi >> 1) * 8);
          mma(acc[2 * np], af, b[0], b[1]);
          mma(acc[2 * np + 1], af, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const GradLayout GL = grad_layout(F, nh, X::KI);
  float* part = partials + size_t(blockIdx.x) * stride;
  if (head) {
    if (threadIdx.x < F) part[GL.w_out + threadIdx.x] = hs;
    else if (threadIdx.x == F) part[GL.b_out] = hs;
  } else if (warp < m_tiles) {
    float* G = part + (job == 0 ? GL.w_in : GL.w_hid + size_t(job - 1) * F * F);
#pragma unroll
    for (int nt = 0; nt < F / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      G[(warp * 16 + g) * F + c] = acc[nt][0];
      G[(warp * 16 + g) * F + c + 1] = acc[nt][1];
      G[(warp * 16 + g + 8) * F + c] = acc[nt][2];
      G[(warp * 16 + g + 8) * F + c + 1] = acc[nt][3];
    }
  } else if (ones_warp && g == 0) {
    float* db = part + GL.b + size_t(job) * F;
#pragma unroll
    for (int nt = 0; nt < F / 8; ++nt) {
      db[nt * 8 + 2 * t] = acc[nt][0];
      db[nt * 8 + 2 * t + 1] = acc[nt][1];
    }
  }
}

// backward, part 3: out[i] = sum over chunks, in chunk order (deterministic)
__global__ void reduce_partials(const float* __restrict__ partials, int n_chunks, long long stride,
                                long long n, float* __restrict__ out) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < n_chunks; ++b) s += partials[b * stride + i];
  out[i] = s;
}

inline bool dims_ok(int F, int nh) { return F >= 16 && F <= 128 && F % 16 == 0 && nh >= 0; }

// the backward's scratch and partials, as the caller allocated them
struct BwdScratch {
  bf16* acts;        // (nh + 1, P, F)
  bf16* dzs;         // (nh + 1, P, F)
  uint2* masks;      // mask_slots(n_sms, nh)
  float* partials;   // n_chunks x grad_layout(F, nh).stride
  int n_chunks;
  long long chunk;   // points per chunk, a multiple of KB
};

// blocks of the backward chain launch over P points
inline int bwd_grid(long long P, int n_sms) {
  const long long tiles = (P + TILE - 1) / TILE;
  return (int)std::min<long long>((tiles + BWD_WARPS - 1) / BWD_WARPS, n_sms);
}

inline long long mask_slots(int n_sms, int nh) {
  return (long long)n_sms * BWD_WARPS * (nh + 1) * 32;
}

inline bool scratch_ok(const BwdScratch& s, long long P, int n_sms) {
  return P <= 0 || (n_sms > 0 && s.n_chunks > 0 && s.chunk > 0 && s.chunk % KB == 0 &&
                    (long long)s.n_chunks * s.chunk >= P);
}

template <int F, class X>
int launch_bwd(const X& x, const float* g, long long P, const Params& prm, int nh,
               const DxOut& dx, const BwdScratch& s, int n_sms, float* grads, cudaStream_t st,
               unsigned long long* tiles_done = nullptr) {
  const GradLayout GL = grad_layout(F, nh, X::KI);
  if (P > 0) {
    const int grid = bwd_grid(P, n_sms);
    const size_t smem = weight_layout(F, nh, X::KI).total;
    cudaError_t e = cudaFuncSetAttribute(bwd_chain_kernel<F, X>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    bwd_chain_kernel<F, X><<<grid, BWD_WARPS * 32, smem, st>>>(x, g, P, prm, nh, s.acts, s.dzs,
                                                               dx, s.masks, tiles_done);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t wsmem = wgrad_smem<X>(F, s.chunk);
    e = cudaFuncSetAttribute(wgrad_kernel<F, X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsmem);
    if (e != cudaSuccess) return (int)e;
    wgrad_kernel<F, X><<<dim3(s.n_chunks, nh + 2), 32 * (F / 16 + 1), wsmem, st>>>(
        x, g, s.acts, s.dzs, P, nh, s.chunk, s.partials, (long long)GL.stride);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int rt = 256;
  reduce_partials<<<(unsigned)((GL.n + rt - 1) / rt), rt, 0, st>>>(
      s.partials, P > 0 ? s.n_chunks : 0, (long long)GL.stride, (long long)GL.n, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// evaluates the expression with the compile-time width FF = F (16, 32, ...,
// 128) and returns its result; an unsupported F returns cudaErrorInvalidValue
#define MLP_CHAIN_DISPATCH_F(F, ...)                           \
  switch (F) {                                                 \
    case 16: { constexpr int FF = 16; return __VA_ARGS__; }    \
    case 32: { constexpr int FF = 32; return __VA_ARGS__; }    \
    case 48: { constexpr int FF = 48; return __VA_ARGS__; }    \
    case 64: { constexpr int FF = 64; return __VA_ARGS__; }    \
    case 80: { constexpr int FF = 80; return __VA_ARGS__; }    \
    case 96: { constexpr int FF = 96; return __VA_ARGS__; }    \
    case 112: { constexpr int FF = 112; return __VA_ARGS__; }  \
    case 128: { constexpr int FF = 128; return __VA_ARGS__; }  \
  }                                                            \
  return (int)cudaErrorInvalidValue;
