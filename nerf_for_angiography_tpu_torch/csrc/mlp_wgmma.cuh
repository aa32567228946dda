// Kernel #1, the CPPN-MLP forward over a (P, 3) or (3, P) input, on Hopper's
// warpgroup MMA (wgmma, sm_90a).  The function and its cast points are those
// of mlp_chain.cuh (x and every weight rounded to bf16 before each product,
// f32 accumulation, f32 bias + relu, bf16 activations, an f32 head dot with
// w_out plus b_out).
//
// Replaces the TPU kernel nerf_for_angiography_tpu/ops/pallas/fused_mlp.py
// ::_fwd_kernel (line 142) as fused_mlp_raw and fused_mlp_raw_fm reach it;
// csrc/fused_mlp.cu::fused_mlp_fwd launches it.  The whole-step kernel's
// forward (#6, csrc/fused_step.cu) is wgmma_march_fwd_kernel below: the
// same chain over a march's samples, on a list of the 16-point tiles that
// hold an active sample.  The encoded forward (#3, csrc/fused_mlp_enc.cu)
// is wgmma_enc_fwd_kernel below: the same chain over the fourier / BARF
// features of EncX, formed in registers as the first layer's A operand.
//
// Bound: at F = 128, n_hidden = 4 a point costs 132,096 FLOP against 16
// bytes of input and output, so the forward is bound by the bf16 tensor
// cores.  The mma.sync forward these kernels replaced gave each warp a
// 16-point tile and read every layer's whole B operand from shared memory
// by ldmatrix for each tile: ~8 KB a point at F = 128, 13.8 GB a launch at
// P = 1,687,500, against the ~30 TB/s the card's shared memory moves (128
// bytes a clock an SM), so shared memory, not the tensor cores, set its
// pace.
//
// Design:
//  * One persistent block per SM stages every weight once into shared memory
//    in wgmma's canonical K-major layouts (the port's weights are (out, in)
//    with in contiguous, which is K-major B): the hidden layers with the
//    128-byte swizzle where F % 64 == 0 (64-wide K panels, 8-row atoms of
//    1024 bytes, 16-byte chunk c of row n at c ^ (n % 8)), the interleaved
//    no-swizzle layout (8 x 16-byte core matrices) at the other widths and
//    for W_in (F x 16, inputs 3..15 zero, so the padding adds exact zeros;
//    #3's is F x KE, its columns in EncX's pair order).
//  * Each warpgroup (4 warps) owns 64-point tiles; warp w holds rows
//    16 w .. 16 w + 15.  A layer is F / 16 wgmma.m64nFk16 with A from
//    registers and B from shared memory, so each B byte feeds 64 points
//    (not 16).  Per warp the f32 accumulator has the mma.sync m16n8 C
//    layout, which is the A layout, so bias + relu + bf16 packing go from
//    the accumulator straight into the next layer's A registers, relu and
//    packing in one cvt.rn.relu.bf16x2.f32 a pair; no activation touches
//    shared memory.
//  * WG_COUNT = 4 warpgroups a block (123 registers a thread at F = 128):
//    the epilogue of some runs on the CUDA cores while the wgmma of others
//    is in flight.  A warpgroup loads its next tile's x before running the
//    current tile's chain.
//  * The ragged edge is masked: rows >= P read x = 0 and are never stored.
//    No TMA: x and out are 16 bytes a point, the weights are staged once.

#pragma once

#include "mlp_chain.cuh"

namespace {

constexpr int WG_COUNT = 4;    // warpgroups a block (at most 128 registers a thread)
constexpr int WG_ROWS = 64;    // points a warpgroup tile

// shared-memory carve-up of the forward's staged weights, from a base
// aligned to 1024 bytes (total includes the alignment slack)
struct WgLayout {
  size_t w_hid, w_in, bias, w_out, total;
};

__host__ __device__ inline WgLayout wg_layout(int F, int nh, int KI = KIN) {
  WgLayout l;
  size_t off = 0;
  l.w_hid = off; off += size_t(nh) * F * F * sizeof(bf16);  // whole 1024-byte atoms when swizzled
  l.w_in = off;  off = align16(off + size_t(F) * KI * sizeof(bf16));
  l.bias = off;  off = align16(off + size_t(nh + 1) * F * sizeof(float));
  l.w_out = off; off = align16(off + size_t(F) * sizeof(float));
  l.total = off + 1024;
  return l;
}

constexpr int ENC_MAX = 32;  // a_j / w_j the encoded forward stages (n_enc <= 30)

// the encoded forward's shared memory: wg_layout's with W_in KE wide, then
// ENC_MAX floats each of a_j and w_j
struct WgEncLayout {
  WgLayout weights;
  size_t enc_a, enc_w, total;
};

__host__ __device__ inline WgEncLayout wg_enc_layout(int F, int nh, int KE) {
  WgEncLayout l;
  l.weights = wg_layout(F, nh, KE);
  l.enc_a = l.weights.total - 1024;  // wg_layout's end, before its alignment slack
  l.enc_w = l.enc_a + ENC_MAX * sizeof(float);
  l.total = l.weights.total + 2 * ENC_MAX * sizeof(float);
  return l;
}

// byte offset of the 16-byte chunk W[n][k .. k + 7] (k % 8 == 0) of an
// (N x K) K-major operand: with SW128 (K % 64 == 0) 64-wide K panels of N
// 128-byte rows, 8-row atoms of 1024 bytes, chunk c of row n at c ^ (n % 8);
// else core matrices of 8 rows x 16 bytes, the K-adjacent ones 128 bytes
// apart, the 8-row groups 16 K bytes apart
template <bool SW128>
__host__ __device__ inline uint32_t wg_chunk_offset(int n, int k, int K, int N) {
  if (SW128)
    return uint32_t((k / 64) * (N * 128) + (n / 8) * 1024 + (n % 8) * 128 +
                    (((k % 64) / 8) ^ (n % 8)) * 16);
  return uint32_t(((n / 8) * (K / 8) + k / 8) * 128 + (n % 8) * 16);
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (0 interleaved, 1 128-byte swizzle)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint32_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(layout) << 62);
}

// the descriptor of k-step kt (K columns 16 kt .. 16 kt + 15) of an (N x K)
// operand staged by wg_chunk_offset<SW128> at shared address base
template <bool SW128>
__device__ __forceinline__ uint64_t wg_kstep_desc(uint32_t base, int kt, int K, int N) {
  if (SW128) return wg_desc(base + (kt / 4) * (N * 128) + (kt % 4) * 32, 16, 1024, 1);
  return wg_desc(base + kt * 256, 128, K * 16, 0);
}

// d (64 x N f32, per warp the m16n8 C layout: d[j][e] is n-tile j) =
// A (64 x 16 bf16, per warp the m16n8k16 A fragment) @ B (16 x N, the
// descriptor b) (+ d where scale_d != 0); asynchronous until wgmma_wait
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[6][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[10][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[12][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[14][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of these registers across
// the asynchronous wgmma region
template <int R>
__device__ __forceinline__ void wg_pin(float (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int R>
__device__ __forceinline__ void wg_pin(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// acc = A (64 x 16 KT, per warp a[kt] its 16 rows' fragments) @ B^T, B the
// (F x K) operand staged at shared address base; returns when it is done
template <int F, int KT, bool SW128>
__device__ __forceinline__ void wg_layer(float (&acc)[F / 8][4], uint32_t (&a)[KT][4],
                                         uint32_t base) {
  wg_pin(acc);
  wg_pin(a);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    wgmma_rs<F>(acc, a[kt], wg_kstep_desc<SW128>(base, kt, 16 * KT, F), kt > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait();
  wg_pin(acc);
  wg_pin(a);
}

// two floats -> one register of two bf16 (round to nearest even) of their
// relu, lo first: one conversion, cvt.rn.relu.bf16x2.f32.  The relu of the
// rounded value is the rounded relu (only the sign of a zero can differ).
__device__ __forceinline__ uint32_t pack2_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a = bf16(relu(acc + bias)), the f32 bias added as in bias_relu_pack
template <int F>
__device__ __forceinline__ void wg_bias_relu_pack(uint32_t (&a)[F / 16][4],
                                                  const float (&acc)[F / 8][4],
                                                  const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < F / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    a[nt >> 1][(nt & 1) * 2] = pack2_relu(acc[nt][0] + b0, acc[nt][1] + b1);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack2_relu(acc[nt][2] + b0, acc[nt][3] + b1);
  }
}

// every weight into the layouts of wg_layout(F, nh, KI): W_in is (F x KI)
template <int F, bool SW128, int KI = KIN>
__device__ void wg_stage_weights(unsigned char* smem, const WgLayout& L, const Params& prm,
                                 int nh) {
  constexpr int VEC = F / 8;  // 16-byte chunks a hidden row
  for (int i = threadIdx.x; i < nh * F * VEC; i += blockDim.x) {
    const int l = i / (F * VEC), n = (i / VEC) % F, k = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(smem + L.w_hid + size_t(l) * F * F * sizeof(bf16) +
                              wg_chunk_offset<SW128>(n, k, F, F)) =
        *reinterpret_cast<const uint4*>(prm.w_hid + (size_t(l) * F + n) * F + k);
  }
  for (int i = threadIdx.x; i < F * (KI / 8); i += blockDim.x) {
    const int n = i / (KI / 8), k = (i % (KI / 8)) * 8;
    *reinterpret_cast<uint4*>(smem + L.w_in + wg_chunk_offset<false>(n, k, KI, F)) =
        *reinterpret_cast<const uint4*>(prm.w_in + n * KI + k);
  }
  float* b = reinterpret_cast<float*>(smem + L.bias);
  for (int i = threadIdx.x; i < (nh + 1) * F; i += blockDim.x) b[i] = prm.bias[i];
  float* wo = reinterpret_cast<float*>(smem + L.w_out);
  for (int i = threadIdx.x; i < F; i += blockDim.x) wo[i] = prm.w_out[i];
}

// this lane's part of the x fragment of the 16 rows at p0 (rows >= P read
// 0): thread t = 0 holds columns 0, 1 of rows g and g + 8, t = 1 column 2
template <class X>
__device__ __forceinline__ void wg_load_x(float (&v)[4], const X& x, long long p0, long long P) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long r0 = p0 + g, r1 = r0 + 8;
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (t < 2) {
    if (r0 < P) {
      v[0] = x(r0, 2 * t);
      if (t == 0) v[1] = x(r0, 1);
    }
    if (r1 < P) {
      v[2] = x(r1, 2 * t);
      if (t == 0) v[3] = x(r1, 1);
    }
  }
}

// the layer chain of a warpgroup's 64 rows (per warp ax, its 16 rows' x
// fragment) and the head's dot with w_out before b_out, summed over this
// thread's columns and then across the four threads of a row: (s0, s1) for
// rows g and g + 8 of this warp.  wgmma_fwd_kernel keeps its own copy of
// these lines: calling this moved its registers at F = 32 (50 -> 58).
template <int F, bool SW128>
__device__ __forceinline__ void wg_chain_head(float& s0, float& s1, uint32_t (&ax)[1][4],
                                              uint32_t s_in, uint32_t s_hid, const float* bias,
                                              const float* wo, int nh) {
  const int t = threadIdx.x & 3;
  float acc[F / 8][4];
  uint32_t a[F / 16][4];
  wg_layer<F, 1, false>(acc, ax, s_in);
  wg_bias_relu_pack<F>(a, acc, bias);
  for (int l = 0; l < nh; ++l) {
    wg_layer<F, F / 16, SW128>(acc, a, s_hid + uint32_t(l) * F * F * sizeof(bf16));
    wg_bias_relu_pack<F>(a, acc, bias + (l + 1) * F);
  }
  // head: f32 products of the bf16 activation with w_out
  s0 = 0.0f;
  s1 = 0.0f;
#pragma unroll
  for (int kt = 0; kt < F / 16; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = kt * 16 + h * 8 + 2 * t;
      const float2 u0 = unpack2(a[kt][h * 2]), u1 = unpack2(a[kt][h * 2 + 1]);
      s0 += u0.x * wo[c] + u0.y * wo[c + 1];
      s1 += u1.x * wo[c] + u1.y * wo[c + 1];
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
}

// out[p] = raw(p), one 64-point tile a warpgroup at a time
template <int F, bool SW128 = (F % 64 == 0)>
__global__ void __launch_bounds__(WG_COUNT * 128, 1)
wgmma_fwd_kernel(StridedX x, long long P, Params prm, int nh, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const WgLayout L = wg_layout(F, nh);
  wg_stage_weights<F, SW128>(smem, L, prm, nh);
  // the generic-proxy stores must be visible to wgmma's reads (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float b_out = prm.b_out[0];
  const float* bias = reinterpret_cast<const float*>(smem + L.bias);
  const float* wo = reinterpret_cast<const float*>(smem + L.w_out);
  const uint32_t s_hid = smem_u32(smem + L.w_hid), s_in = smem_u32(smem + L.w_in);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long n_tiles = (P + WG_ROWS - 1) / WG_ROWS;
  const long long step = (long long)gridDim.x * WG_COUNT;
  long long tile = (long long)blockIdx.x * WG_COUNT + wg;  // uniform over the warpgroup
  float v[4];
  if (tile < n_tiles) wg_load_x(v, x, tile * WG_ROWS + warp * 16, P);
  for (; tile < n_tiles; tile += step) {
    const long long p0 = tile * WG_ROWS + warp * 16;
    uint32_t ax[1][4] = {{pack2(v[0], v[1]), pack2(v[2], v[3]), 0u, 0u}};
    if (tile + step < n_tiles) wg_load_x(v, x, p0 + step * WG_ROWS, P);
    float acc[F / 8][4];
    uint32_t a[F / 16][4];
    wg_layer<F, 1, false>(acc, ax, s_in);
    wg_bias_relu_pack<F>(a, acc, bias);
    for (int l = 0; l < nh; ++l) {
      wg_layer<F, F / 16, SW128>(acc, a, s_hid + uint32_t(l) * F * F * sizeof(bf16));
      wg_bias_relu_pack<F>(a, acc, bias + (l + 1) * F);
    }
    // head: f32 products of the bf16 activation with w_out, summed over
    // this thread's columns and then across the four threads of a row
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int kt = 0; kt < F / 16; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kt * 16 + h * 8 + 2 * t;
        const float2 u0 = unpack2(a[kt][h * 2]), u1 = unpack2(a[kt][h * 2 + 1]);
        s0 += u0.x * wo[c] + u0.y * wo[c + 1];
        s1 += u1.x * wo[c] + u1.y * wo[c + 1];
      }
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (t == 0) {
      if (p0 + g < P) out[p0 + g] = s0 + b_out;
      if (p0 + g + 8 < P) out[p0 + g + 8] = s1 + b_out;
    }
  }
}

// Kernel #6's forward: sigma[p] = sigmoid(raw(p)) at the samples of a
// march (MarchX), computed only on the 16-point tiles of ``list`` (``*count``
// tile indices, in any order: the tiles holding a sample with mask != 0).
// Warp w of a warpgroup forms x for list entry 4 i + w, so the 64 rows of a
// wgmma are four active tiles, not 64 consecutive points; a warp past the
// list's end feeds rows of zeros and stores nothing.  The chain, its cast
// points and the head are wgmma_fwd_kernel's, then the sigmoid of
// mlp_chain.cuh's fwd_kernel, so sigma is the same bit for bit.
template <int F, bool SW128 = (F % 64 == 0)>
__global__ void __launch_bounds__(WG_COUNT * 128, 1)
wgmma_march_fwd_kernel(MarchX x, const int* __restrict__ list, const int* __restrict__ count,
                       long long P, Params prm, int nh, float* __restrict__ sigma) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const WgLayout L = wg_layout(F, nh);
  wg_stage_weights<F, SW128>(smem, L, prm, nh);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float b_out = prm.b_out[0];
  const float* bias = reinterpret_cast<const float*>(smem + L.bias);
  const float* wo = reinterpret_cast<const float*>(smem + L.w_out);
  const uint32_t s_hid = smem_u32(smem + L.w_hid), s_in = smem_u32(smem + L.w_in);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = *count;
  const int n_items = (n + 3) / 4;  // four tiles a warpgroup item
  const int step = gridDim.x * WG_COUNT;
  // the first point of this warp's tile of item i; P (rows read as zeros,
  // never stored) past the list's end
  auto tile_p0 = [&](int i) {
    const int e = 4 * i + warp;
    return e < n ? (long long)list[e] * TILE : P;
  };
  int item = blockIdx.x * WG_COUNT + wg;  // uniform over the warpgroup
  long long p0 = P;
  float v[4];
  if (item < n_items) {
    p0 = tile_p0(item);
    wg_load_x(v, x, p0, P);
  }
  for (; item < n_items; item += step) {
    const long long q0 = p0;
    uint32_t ax[1][4] = {{pack2(v[0], v[1]), pack2(v[2], v[3]), 0u, 0u}};
    if (item + step < n_items) {
      p0 = tile_p0(item + step);
      wg_load_x(v, x, p0, P);
    }
    float s0, s1;
    wg_chain_head<F, SW128>(s0, s1, ax, s_in, s_hid, bias, wo, nh);
    if (t == 0) {
      s0 += b_out;
      s1 += b_out;
      if (q0 + g < P) sigma[q0 + g] = 1.0f / (1.0f + expf(-s0));
      if (q0 + g + 8 < P) sigma[q0 + g + 8] = 1.0f / (1.0f + expf(-s1));
    }
  }
}

// Kernel #3: out[p] = raw(p) over the fourier / BARF encoding of x (EncX),
// one 64-point tile a warpgroup at a time.  Each warp forms its 16 rows' KE
// / 16 A fragments in registers as warp_forward does (register q of k-step
// kt holds row g + 8 (q & 1), pair 8 kt + 4 (q >> 1) + t in EncX's pair
// order), which is wgmma's per-warp A layout, so the first layer is KE / 16
// wgmma.m64nFk16 from registers over W_in (F x KE, its columns in pair
// order, staged K-major without swizzle) and the features never touch
// shared or device memory.  a_j and w_j are staged beside the weights and
// EncX::pair forms each pair from them: full-precision sincosf of one f32
// product, times w_j in f32, rounded to bf16 where it enters the product.
// The hidden chain and the head are wgmma_fwd_kernel's lines, written out
// again (not a helper #1 would share).  A warpgroup loads its next tile's
// coordinates (six floats a lane) before it runs the current tile's chain.
// Rows >= P read the coordinates of a zero point and are never stored.
template <int F, int KE, bool SW128 = (F % 64 == 0)>
__global__ void __launch_bounds__(WG_COUNT * 128, 1)
wgmma_enc_fwd_kernel(EncX<KE> x, long long P, Params prm, int nh, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const WgEncLayout E = wg_enc_layout(F, nh, KE);
  const WgLayout& L = E.weights;
  wg_stage_weights<F, SW128, KE>(smem, L, prm, nh);
  float* sa = reinterpret_cast<float*>(smem + E.enc_a);
  float* sw = reinterpret_cast<float*>(smem + E.enc_w);
  for (int i = threadIdx.x; i < x.n_enc; i += blockDim.x) {
    sa[i] = x.a[i];
    sw[i] = x.w[i];
  }
  // the generic-proxy stores must be visible to wgmma's reads (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  EncX<KE> xe = x;  // its pairs from the staged a_j, w_j
  xe.a = sa;
  xe.w = sw;
  const float b_out = prm.b_out[0];
  const float* bias = reinterpret_cast<const float*>(smem + L.bias);
  const float* wo = reinterpret_cast<const float*>(smem + L.w_out);
  const uint32_t s_hid = smem_u32(smem + L.w_hid), s_in = smem_u32(smem + L.w_in);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long n_tiles = (P + WG_ROWS - 1) / WG_ROWS;
  const long long step = (long long)gridDim.x * WG_COUNT;
  long long tile = (long long)blockIdx.x * WG_COUNT + wg;  // uniform over the warpgroup
  // this lane's rows g and g + 8 of the warp's 16 at q0
  const float3 zero = make_float3(0.0f, 0.0f, 0.0f);
  float3 c0 = zero, c1 = zero;
  auto load_coords = [&](long long q0) {
    c0 = q0 + g < P ? x.coords(q0 + g) : zero;
    c1 = q0 + g + 8 < P ? x.coords(q0 + g + 8) : zero;
  };
  if (tile < n_tiles) load_coords(tile * WG_ROWS + warp * 16);
  for (; tile < n_tiles; tile += step) {
    const long long p0 = tile * WG_ROWS + warp * 16;
    constexpr int KT = KE / 16;
    uint32_t ax[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * kt + 4 * h + t;
        const float2 u0 = xe.pair(c0, m), u1 = xe.pair(c1, m);
        ax[kt][2 * h] = pack2(u0.x, u0.y);
        ax[kt][2 * h + 1] = pack2(u1.x, u1.y);
      }
    }
    if (tile + step < n_tiles) load_coords(p0 + step * WG_ROWS);
    float acc[F / 8][4];
    uint32_t a[F / 16][4];
    wg_layer<F, KT, false>(acc, ax, s_in);
    wg_bias_relu_pack<F>(a, acc, bias);
    for (int l = 0; l < nh; ++l) {
      wg_layer<F, F / 16, SW128>(acc, a, s_hid + uint32_t(l) * F * F * sizeof(bf16));
      wg_bias_relu_pack<F>(a, acc, bias + (l + 1) * F);
    }
    // head: f32 products of the bf16 activation with w_out, summed over
    // this thread's columns and then across the four threads of a row
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int kt = 0; kt < F / 16; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kt * 16 + h * 8 + 2 * t;
        const float2 u0 = unpack2(a[kt][h * 2]), u1 = unpack2(a[kt][h * 2 + 1]);
        s0 += u0.x * wo[c] + u0.y * wo[c + 1];
        s1 += u1.x * wo[c] + u1.y * wo[c + 1];
      }
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (t == 0) {
      if (p0 + g < P) out[p0 + g] = s0 + b_out;
      if (p0 + g + 8 < P) out[p0 + g + 8] = s1 + b_out;
    }
  }
}

template <int F>
int launch_wgmma_fwd(const StridedX& x, long long P, const Params& prm, int nh, float* out,
                     int n_sms, cudaStream_t st) {
  if (P <= 0) return (int)cudaSuccess;
  const long long tiles = (P + WG_ROWS - 1) / WG_ROWS;
  const int grid = (int)std::min<long long>((tiles + WG_COUNT - 1) / WG_COUNT, n_sms);
  const size_t smem = wg_layout(F, nh).total;
  cudaError_t e = cudaFuncSetAttribute(wgmma_fwd_kernel<F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_fwd_kernel<F><<<grid, WG_COUNT * 128, smem, st>>>(x, P, prm, nh, out);
  return (int)cudaGetLastError();
}

// kernel #6's forward over the active tiles of a march of P < 2^31 samples
// (list, count in device memory, written earlier on the stream); the grid
// covers the case where every tile is active
template <int F>
int launch_wgmma_march_fwd(const MarchX& x, const int* list, const int* count, long long P,
                           const Params& prm, int nh, float* sigma, int n_sms, cudaStream_t st) {
  if (P <= 0) return (int)cudaSuccess;
  const long long items = ((P + TILE - 1) / TILE + 3) / 4;
  const int grid = (int)std::min<long long>((items + WG_COUNT - 1) / WG_COUNT, n_sms);
  const size_t smem = wg_layout(F, nh).total;
  cudaError_t e = cudaFuncSetAttribute(wgmma_march_fwd_kernel<F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_march_fwd_kernel<F><<<grid, WG_COUNT * 128, smem, st>>>(x, list, count, P, prm, nh,
                                                                sigma);
  return (int)cudaGetLastError();
}

// kernel #3 over P points of an encoded input (KE <= F, n_enc <= ENC_MAX)
template <int F, int KE>
int launch_wgmma_enc_fwd(const EncX<KE>& x, long long P, const Params& prm, int nh, float* out,
                         int n_sms, cudaStream_t st) {
  if (P <= 0) return (int)cudaSuccess;
  if (x.n_enc > ENC_MAX) return (int)cudaErrorInvalidValue;
  const long long tiles = (P + WG_ROWS - 1) / WG_ROWS;
  const int grid = (int)std::min<long long>((tiles + WG_COUNT - 1) / WG_COUNT, n_sms);
  const size_t smem = wg_enc_layout(F, nh, KE).total;
  cudaError_t e = cudaFuncSetAttribute(wgmma_enc_fwd_kernel<F, KE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_enc_fwd_kernel<F, KE><<<grid, WG_COUNT * 128, smem, st>>>(x, P, prm, nh, out);
  return (int)cudaGetLastError();
}

}  // namespace
