// Kernel #2, the MLP backward over a (P, 3) or (3, P) input (GatedX), with
// its weight gradients kept on chip: one persistent launch of thread-block
// clusters, then mlp_chain.cuh's reduce_partials.
//
// Replaces, as the two-kernel backward of mlp_chain.cuh did, the TPU kernel
// nerf_for_angiography_tpu/ops/pallas/fused_mlp.py::_bwd_kernel (line 160)
// as fused_mlp_raw and fused_mlp_raw_fm reach it; csrc/fused_mlp.cu::
// fused_mlp_bwd launches it where F is 64 or 128 and a block's shared memory
// holds its ring of activations (oc_dims_ok), else the two-kernel backward.
// The gradients and dx are the two-kernel backward's bit for bit (but for
// the sign of a zero).
//
// Bound: at F = 128, n_hidden = 4 an active point costs 396,032 operations
// (the forward recomputed, dW and dh), about 0.07 ms of bf16 tensor-core
// work at the ~167 k active points of a compacted CT step.  The two-kernel
// backward wrote every layer's bf16 activation and dz of every active tile
// to device memory and read them back, 8 (n_hidden + 1) F = 5,120 bytes a
// point (0.26 ms at 3.35 TB/s).  Here x, g, dx and each chunk's f32 partial
// are all that touch device memory; what bounds the kernel is the latency
// of each tick's epilogues, products and cluster barrier.
//
// Design:
//  * The chunks (BwdScratch.make's partition) go to persistent clusters of
//    C = n_hidden blocks, chunks c, c + n_clusters, ... to cluster c.  Block
//    r owns hidden layer r + 1 (W_hid[r], staged once in mlp_wgmma.cuh's
//    128-byte-swizzled K-major layout) and keeps dW_{r+1}, db_{r+1} of the
//    chunk in registers (f32).  Block 0 also owns the input layer (dW_0,
//    db_0, dx), the last block the head (dw_out, db_out, f32 sums).
//  * An item is the chunk's next four active 16-point tiles, in the order
//    wgrad_kernel's stages take them; one warp (block 1's warp 8) reads g
//    a 32-tile window ahead and posts each item to every block.
//  * The cluster runs in ticks, each closed by a relaxed cluster barrier.
//    At tick t block r runs the forward of item t - r and the backward of
//    item t - 2C + 1 + r, on three warpgroups: 0 computes a_{r+1} = relu(a_r
//    W^T + b) (wgmma from registers; block 0 forms a_0 from x first; the
//    last block also forms the head dz_C = bf16(w_out g) where a_C > 0, which
//    its backward takes a tick later) and db_{r+1}; 1 computes dh_r =
//    dz_{r+1} W (wgmma, W read as the transposed B), masked by a_r > 0 and
//    rounded to bf16, dz_r (block 0 also a_0 again, dW_0 and db_0); 2 adds
//    dz_{r+1}^T a_r into dW_{r+1} (block 0 also dx; the last block dw_out).
//  * a_{r+1} and dz_r are staged by stmatrix (dz transposed: the K-major B
//    operand of dW) and sent to the neighbouring block by one bulk copy
//    each, completed on the receiver's mbarrier; block r keeps its input a_r
//    of an item in a ring for the 2C - 2r ticks between its forward and
//    its backward.  No activation, dz or relu mask reaches device memory.
//  * The weight gradients are the 16-point k-steps of wgrad_kernel on the
//    same operands in the same order (the chunk's tiles, then a tile's
//    points): dW as wgmma k16 steps (whose products equal mma.sync's, as
//    kernel #1's do), db, dW_0 and db_0 as wgrad_kernel's mma.sync with an
//    all-ones or x A operand, dw_out / db_out its f32 lines; dx is the
//    chain's warp_mm_t.  So each chunk's partial is one accumulator's sum
//    over the same tiles in the same order; at a chunk's change each block
//    writes its slice where wgrad_kernel wrote it (a chunk with no active
//    tile gets one empty item, so zeros), and reduce_partials sums them.
//  * The active tiles found are added into the counter once a cluster.

#pragma once

#include <cooperative_groups.h>

#include "mlp_chain.cuh"
#include "mlp_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int OC_THREADS = 384;    // three warpgroups a block
constexpr int OC_ROWS = 64;        // points an item (four 16-point tiles)
constexpr int OC_MAX_CLUSTER = 8;  // the portable cluster size

// an item of a cluster's stream: up to four active tiles of one chunk
struct OcItem {
  long long p0[4];  // first point of each tile; -1: rows of zeros
  int chunk;        // -1: the end of the cluster's stream
  int n;            // tiles
};

// 64 x F bf16 slots a block holds: block 0 a_0 and dz_0, block r >= 1 a
// ring of 2C - 2r + 1 inputs, and the last block two more for a_C
__host__ __device__ inline int oc_slots(int C) {
  return C == 1 ? 4 : (2 * C - 1 > 5 ? 2 * C - 1 : 5);
}

// items in flight a block keeps: from block 0's backward (2C - 1 ticks
// behind its forward) to the next item prefetched, and the one posted
__host__ __device__ inline int oc_items(int C) { return 2 * C + 2; }

// shared-memory carve-up of a block (every block of the launch the same),
// from a base aligned to 1024 bytes (total includes the alignment slack)
struct OcLayout {
  size_t w, slots, dz, stage, win, winc, bias, wout, xs, gs, desc, mbar, total;
};

__host__ __device__ inline OcLayout oc_layout(int F, int nh) {
  OcLayout l;
  const size_t mat = size_t(F) * F * sizeof(bf16), slot = size_t(OC_ROWS) * F * sizeof(bf16);
  size_t off = 0;
  l.w = off;     off += mat;                          // W, 128-byte swizzled K-major
  l.slots = off; off += size_t(oc_slots(nh)) * slot;
  l.dz = off;    off += 2 * slot;                     // dz_{r+1} in, by item parity
  l.stage = off; off += 2 * slot;                     // a_{r+1} and dz_r out, to copy
  l.win = off;   off += size_t(F) * KIN * sizeof(bf16);            // W_in for wgmma
  l.winc = off;  off = align16(off + size_t(F) * ldin(KIN) * sizeof(bf16));  // for warp_mm_t
  l.bias = off;  off = align16(off + size_t(2) * F * sizeof(float));     // layers 0, r + 1
  l.wout = off;  off = align16(off + size_t(F) * sizeof(float));
  l.xs = off;    off = align16(off + size_t(OC_ROWS) * ldin(KIN) * sizeof(bf16));
  l.gs = off;    off = align16(off + 2 * OC_ROWS * sizeof(float));
  l.desc = off;  off += size_t(oc_items(nh)) * sizeof(OcItem);
  l.mbar = off;  off += size_t(oc_slots(nh) + 2) * sizeof(unsigned long long);  // ring, dz
  l.total = off + 1024;
  return l;
}

// largest dynamic shared memory a block may use on Hopper
constexpr size_t OC_MAX_SMEM = 232448;

inline bool oc_dims_ok(int F, int nh) {
  return (F == 64 || F == 128) && nh >= 1 && nh <= OC_MAX_CLUSTER &&
         oc_layout(F, nh).total <= OC_MAX_SMEM;
}

// byte offset of element (p, c) of a 64 x F bf16 slot: rows of F, the
// 16-byte chunk k of row p at k ^ (p % 8), so the eight rows an ldmatrix or
// stmatrix touches at one column lie in eight different bank groups
template <int F>
__device__ __forceinline__ uint32_t oc_off(int p, int c) {
  return uint32_t(p * F * 2 + ((((c >> 3) ^ (p & 7))) << 4) + (c & 7) * 2);
}

// byte offset of dz element (point p, feature f) in a dz^T slot: F rows of
// the 64 points, the B operand of dW in wgmma's 128-byte-swizzled K-major
// layout (wg_chunk_offset<true> with K = 64)
template <int F>
__device__ __forceinline__ uint32_t oc_dzt_off(int f, int p) {
  return wg_chunk_offset<true>(f, p & ~7, OC_ROWS, F) + uint32_t(p & 7) * 2;
}

// four 8 x 8 bf16 matrices from their m16n8 fragments into shared memory
// (lane l gives the address of row l % 8 of matrix l / 8); .trans stores
// each transposed
__device__ __forceinline__ void stsm_x4(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stsm_x4_t(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// d (64 x N f32) = A (64 x 16, per warp the m16n8k16 A fragment) @ B (16 x
// N) with B MN-major (wgmma's transposed B: N contiguous), the descriptor b
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// acc = dz (64 x F, per warp a[kt] its 16 rows' fragments, K = the layer's
// outputs) @ W (F x F, out x in) with W the forward's staged B at shared
// address base read as wgmma's transposed (MN-major) B: its rows are the
// outputs (K) and its 64-wide panels of inputs (N) lie F x 128 bytes apart
template <int F>
__device__ __forceinline__ void oc_layer_tb(float (&acc)[F / 8][4], uint32_t (&a)[F / 16][4],
                                            uint32_t base) {
  wg_pin(acc);
  wg_pin(a);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < F / 16; ++kt)
    wgmma_rs_tb<F>(acc, a[kt], wg_desc(base + kt * 2048, F * 128, 1024, 1), kt > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait();
  wg_pin(acc);
  wg_pin(a);
}

// mbarriers (one arrival a phase) for the slots another block copies in
__device__ __forceinline__ void oc_mbar_init(uint32_t a) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
}
__device__ __forceinline__ void oc_mbar_expect(uint32_t a, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void oc_mbar_wait(uint32_t a, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nOC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra OC_WAIT;\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}
// a shared-memory address of this block as block `rank` of the cluster has it
__device__ __forceinline__ uint32_t oc_mapa(uint32_t a, int rank) {
  uint32_t m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(m) : "r"(a), "r"(rank));
  return m;
}
// copy `bytes` of this block's shared memory at src into block memory of the
// cluster at dst (mapped), completing them on the mbarrier mbar (mapped)
__device__ __forceinline__ void oc_bulk_copy(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(mbar)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the bulk copies this thread issued have read their source
__device__ __forceinline__ void oc_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the forward's epilogue: a = bf16(relu(acc + bias)) by stmatrix into the
// slot at dst (this warp's 16 rows); with HEAD also dz_C = bf16(w_out g)
// where a > 0 (g: gv0, gv1 of rows g and g + 8) by stmatrix.trans into the
// dz^T slot at dzh
template <int F, bool HEAD>
__device__ __forceinline__ void oc_fwd_epilogue(const float (&acc)[F / 8][4], const float* bias1,
                                                const float* wo, float gv0, float gv1,
                                                unsigned char* dst, unsigned char* dzh, int mrow,
                                                int mcol) {
  const int lane = threadIdx.x & 31, t = lane & 3, wiw = (threadIdx.x >> 5) & 3;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int np = 0; np < F / 16; ++np) {
    uint32_t u[4], d[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nt = 2 * np + e, c = nt * 8 + 2 * t;
      const float b0 = bias1[c], b1 = bias1[c + 1];
      u[2 * e] = pack2(fmaxf(acc[nt][0] + b0, 0.0f), fmaxf(acc[nt][1] + b1, 0.0f));
      u[2 * e + 1] = pack2(fmaxf(acc[nt][2] + b0, 0.0f), fmaxf(acc[nt][3] + b1, 0.0f));
      if constexpr (HEAD) {
        const float2 w0 = unpack2(u[2 * e]), w1 = unpack2(u[2 * e + 1]);
        const float o0 = wo[c], o1 = wo[c + 1];
        d[2 * e] = pack2(w0.x > 0.0f ? o0 * gv0 : 0.0f, w0.y > 0.0f ? o1 * gv0 : 0.0f);
        d[2 * e + 1] = pack2(w1.x > 0.0f ? o0 * gv1 : 0.0f, w1.y > 0.0f ? o1 * gv1 : 0.0f);
      }
    }
    stsm_x4(dst + oc_off<F>(mrow, np * 16 + mcol), u[0], u[1], u[2], u[3]);
    if constexpr (HEAD)
      stsm_x4_t(dzh + oc_dzt_off<F>(np * 16 + mcol + rr, 16 * wiw + (mi & 1) * 8), d[0], d[1],
                d[2], d[3]);
  }
}

// the tick barrier: execution across the cluster (a relaxed arrive, so no
// thread waits here for its outstanding loads); data between blocks goes
// through mbarriers (bulk copies), and what a later tick reads of another
// thread's stores is fenced by its writer (the item posts, the head)
__device__ __forceinline__ void oc_tick_barrier() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The scanning warp: the next item of the cluster's stream (every lane the
// same).  The chunk's tiles are read 32 at a time (16 coalesced loads of g
// a window), as wgrad_kernel's stage bits; a chunk with no active tile
// gives one empty item.
struct OcScan {
  int ci, step;       // current chunk; chunks a cluster steps by
  long long wtile;    // next window's first tile, from the chunk's first
  long long wbase;    // the loaded window's first tile
  uint32_t mask;      // its active tiles not yet taken
  bool emitted;       // chunk ci has had an item
  bool have_next;     // nv holds window wtile's g (loaded ahead)
  float nv[16];
};

// this lane's 16 g of the window of 32 tiles at tile wt of chunk ci (0 past
// the chunk or P)
template <class X>
__device__ __forceinline__ void oc_window(float (&v)[16], const X& x, long long P,
                                          long long chunk, int ci, long long wt) {
  const int lane = threadIdx.x & 31;
  const long long c_lo = (long long)ci * chunk;
  const long long c_hi = c_lo + chunk < P ? c_lo + chunk : P;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long p = c_lo + wt * TILE + i * 32 + lane;
    v[i] = p < c_hi ? x.g[p] : 0.0f;
  }
}

// after a post: load the chunk's next window ahead of its use
template <class X>
__device__ __forceinline__ void oc_scan_prefetch(OcScan& s, const X& x, long long P,
                                                 long long chunk, int n_chunks) {
  if (s.have_next || s.ci >= n_chunks) return;
  const long long c_lo = (long long)s.ci * chunk;
  const long long c_hi = c_lo + chunk < P ? c_lo + chunk : P;
  if (s.wtile < (c_hi - c_lo + TILE - 1) / TILE) {
    oc_window(s.nv, x, P, chunk, s.ci, s.wtile);
    s.have_next = true;
  }
}

template <class X>
__device__ __forceinline__ OcItem oc_next_item(OcScan& s, const X& x, long long P, long long chunk, int n_chunks,
                               unsigned int& n_active) {
  OcItem it;
  it.p0[0] = it.p0[1] = it.p0[2] = it.p0[3] = -1;
  it.n = 0;
  it.chunk = -1;
  while (s.ci < n_chunks) {
    const long long c_lo = (long long)s.ci * chunk;
    const long long c_hi = c_lo + chunk < P ? c_lo + chunk : P;
    const long long c_tiles = (c_hi - c_lo + TILE - 1) / TILE;
    while (it.n < 4) {
      if (s.mask == 0u) {
        if (s.wtile >= c_tiles) break;
        float gv[16];
        if (s.have_next) {
#pragma unroll
          for (int i = 0; i < 16; ++i) gv[i] = s.nv[i];
          s.have_next = false;
        } else {
          oc_window(gv, x, P, chunk, s.ci, s.wtile);
        }
        uint32_t m = 0u;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          // a point is active where g != 0 (-0 counts as zero), as GatedX says
          const uint32_t v = __ballot_sync(0xffffffffu, gv[i] != 0.0f);
          m |= ((v & 0xFFFFu) ? 1u : 0u) << (2 * i);
          m |= ((v >> 16) ? 1u : 0u) << (2 * i + 1);
        }
        s.wbase = s.wtile;
        s.wtile += 32;
        s.mask = m;
        continue;
      }
      const int b = __ffs((int)s.mask) - 1;
      s.mask &= s.mask - 1u;
      const long long p0 = c_lo + (s.wbase + b) * TILE;
      // constant indices keep the item in registers
      if (it.n == 0) it.p0[0] = p0;
      else if (it.n == 1) it.p0[1] = p0;
      else if (it.n == 2) it.p0[2] = p0;
      else it.p0[3] = p0;
      ++it.n;
    }
    if (it.n > 0 || !s.emitted) {
      it.chunk = s.ci;
      s.emitted = true;
      n_active += it.n;
      return it;
    }
    s.ci += s.step;
    s.wtile = 0;
    s.mask = 0u;
    s.emitted = false;
    s.have_next = false;
  }
  return it;
}

// the scanning warp: item i of the stream into slot i % oc_items(C) of
// every block's ring of items (lane k writes block k's)
__device__ __forceinline__ void oc_post(cg::cluster_group& cluster, OcItem* desc, int slot,
                                        const OcItem& it, int C) {
  const int lane = threadIdx.x & 31;
  if (lane < C) {
    OcItem* d = cluster.map_shared_rank(desc, (unsigned)lane) + slot;
    *d = it;
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  }
}

// a named barrier of one warpgroup, or of two (one warpgroup arrives, the
// other waits)
__device__ __forceinline__ void oc_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void oc_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int F, class X>
__global__ void __launch_bounds__(OC_THREADS, 1)
onchip_bwd_kernel(X x, const float* __restrict__ gr, long long P, Params prm, int nh,
                  long long chunk, int n_chunks, float* __restrict__ partials, long long stride,
                  DxOut dx, unsigned long long* __restrict__ tiles_done) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = nh;
  const int r = (int)cluster.block_rank();
  const int n_cl = (int)gridDim.x / C, cid = (int)blockIdx.x / C;
  const OcLayout L = oc_layout(F, nh);
  const int tid = threadIdx.x, wg = tid >> 7, wiw = (tid >> 5) & 3, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  constexpr uint32_t SLOT = uint32_t(OC_ROWS) * F * sizeof(bf16);
  constexpr int NPW = F / 64;  // n-pairs of db (dW_0, db_0) a warp of a warpgroup
  const bool first = r == 0, last = r == C - 1;
  const int S = first ? 1 : 2 * C - 2 * r + 1;            // ring of the inputs a_r
  const int S_next = last ? 1 : 2 * C - 2 * (r + 1) + 1;  // block r + 1's
  unsigned char* slots = smem + L.slots;
  // block 0: a_0 of the backward's item (slot 0) and dz_0 (slot 1); the last
  // block: a_C of the head's items, by parity (after its ring)
  unsigned char* dz0 = slots + SLOT;
  unsigned char* anh = slots + (first ? 2 : S) * SLOT;
  unsigned char* dzb = smem + L.dz;
  unsigned char* xs = smem + L.xs;
  float* gs = reinterpret_cast<float*>(smem + L.gs);  // the head's g, by parity
  OcItem* desc = reinterpret_cast<OcItem*>(smem + L.desc);
  const float* bias0 = reinterpret_cast<const float*>(smem + L.bias);  // layer 0's
  const float* bias1 = bias0 + F;                                      // layer r + 1's
  const float* wo = reinterpret_cast<const float*>(smem + L.wout);
  const bf16* winc = reinterpret_cast<const bf16*>(smem + L.winc);
  const int DR = oc_items(C);
  const GradLayout GL = grad_layout(F, nh);

  // stage W_hid[r] (out, in) K-major: B of a_r W^T, and read as the
  // transposed B, of dz W
  {
    const bf16* wl = prm.w_hid + size_t(r) * F * F;
    for (int i = tid; i < F * F / 8; i += OC_THREADS) {
      const int n = i / (F / 8), k = (i % (F / 8)) * 8;
      *reinterpret_cast<uint4*>(smem + L.w + wg_chunk_offset<true>(n, k, F, F)) =
          *reinterpret_cast<const uint4*>(wl + size_t(n) * F + k);
    }
    if (first) {
      for (int i = tid; i < F * (KIN / 8); i += OC_THREADS) {
        const int n = i / (KIN / 8), k = (i % (KIN / 8)) * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(prm.w_in + n * KIN + k);
        *reinterpret_cast<uint4*>(smem + L.win + wg_chunk_offset<false>(n, k, KIN, F)) = v;
        *reinterpret_cast<uint4*>(smem + L.winc + (size_t(n) * ldin(KIN) + k) * sizeof(bf16)) = v;
      }
      // bf16(x) rows for dW_0: columns 3 .. 15 stay zero
      for (int i = tid; i < OC_ROWS * ldin(KIN) / 2; i += OC_THREADS)
        reinterpret_cast<uint32_t*>(xs)[i] = 0u;
    }
    float* b = reinterpret_cast<float*>(smem + L.bias);
    for (int i = tid; i < F; i += OC_THREADS) {
      b[i] = prm.bias[i];
      b[F + i] = prm.bias[size_t(r + 1) * F + i];
    }
    float* w = reinterpret_cast<float*>(smem + L.wout);
    for (int i = tid; i < F; i += OC_THREADS) w[i] = prm.w_out[i];
  }
  // the mbarriers of this block's ring of inputs and of its dz slots
  const int NS = oc_slots(nh);
  const uint32_t s_mbar = smem_u32(smem + L.mbar);
  if (tid == 0) {
    for (int i = 0; i < NS + 2; ++i) oc_mbar_init(s_mbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  auto bar_a = [&](int slot) { return s_mbar + 8 * slot; };
  auto bar_dz = [&](int par) { return s_mbar + 8 * (NS + par); };
  // the generic-proxy stores must be visible to wgmma's reads (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t s_w = smem_u32(smem + L.w);
  unsigned char* stage_a = smem + L.stage;          // a_{r+1} out
  unsigned char* stage_dz = smem + L.stage + SLOT;  // dz_r out
  const uint32_t s_win = smem_u32(smem + L.win);
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  const int r0 = 16 * wiw + g, r1 = r0 + 8;
  // stmatrix / ldmatrix x4 over n-tiles 2 np, 2 np + 1 of this warp's 16
  // rows: this lane's row and the first column of its matrix's n-tile
  const int mrow = 16 * wiw + (mi & 1) * 8 + rr, mcol = (mi >> 1) * 8;

  // the block whose warp 8 (warpgroup 2's first) finds the items: block 1
  // where there is one (block 0 carries the input layer)
  const bool scanner = r == (C > 1 ? 1 : 0) && warp == 8;
  OcScan sc{cid, n_cl, 0, 0, 0u, false, false, {}};
  unsigned int n_active = 0;
  if (scanner) {
    oc_post(cluster, desc, 0, oc_next_item(sc, x, P, chunk, n_chunks, n_active), C);
    oc_post(cluster, desc, 1, oc_next_item(sc, x, P, chunk, n_chunks, n_active), C);
  }
  cluster.sync();

  // Three warpgroups, one layer product each, in ticks closed by the
  // cluster barrier: warpgroup 0 the forward of item f (the last block also
  // forms the head of item f, which its backward takes a tick later),
  // warpgroup 1 the backward of item b (dh), warpgroup 2 dW_{r+1} of item
  // b.  Each keeps its own accumulators over the chunk and writes them to
  // the chunk's partial where wgrad_kernel writes them when the chunk
  // changes.  Device-memory loads for the next tick's items are issued
  // before each tick's barrier.  Named barriers: 1 warpgroup 0; 2 warpgroup
  // 1 -> 2 (block 0's a_0); 3 warpgroup 1; 4 warpgroup 1 -> 2 (dz_0).
  auto p0_of = [&](int i) { return i < 0 ? -1ll : desc[i % DR].p0[wiw]; };
  int end = 0x7fffffff, cur = -1;
  auto item_flags = [&](int tick, int& f, int& b, bool& fv, bool& bv) {
    f = tick - r;
    b = tick - (2 * C - 1 - r);
    if (f >= 0 && f < end && desc[f % DR].chunk < 0) end = f;
    fv = f >= 0 && f < end;
    bv = b >= 0 && b < end;
  };
  auto done = [&](int tick) { return end != 0x7fffffff && tick >= end + 2 * C - 2; };

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n");
    // db_{r+1} of n-pairs NPW wiw .. and, on the last block, db_out (thread 0)
    float dbs[2 * NPW][4];
#pragma unroll
    for (int j = 0; j < 2 * NPW; ++j) dbs[j][0] = dbs[j][1] = dbs[j][2] = dbs[j][3] = 0.0f;
    float hs = 0.0f;
    auto flush = [&](int ci) {
      float* part = partials + size_t(ci) * stride;
#pragma unroll
      for (int e = 0; e < 2 * NPW; ++e) {
        const int c = (2 * NPW * wiw + e) * 8 + 2 * t;
        if (g == 0) {
          part[GL.b + size_t(r + 1) * F + c] = dbs[e][0];
          part[GL.b + size_t(r + 1) * F + c + 1] = dbs[e][1];
        }
        dbs[e][0] = dbs[e][1] = dbs[e][2] = dbs[e][3] = 0.0f;
      }
      if (last && tid == 0) part[GL.b_out] = hs;
      hs = 0.0f;
    };
    float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // block 0: x of this warp's tile of item f
    float gv0 = 0.0f, gv1 = 0.0f;            // last block: g of rows r0, r1 of item f
    auto prefetch = [&](int i) {
      const long long p0 = p0_of(i);
      if (first) {
        xv[0] = xv[1] = xv[2] = xv[3] = 0.0f;
        if (p0 >= 0) wg_load_x(xv, x, p0, P);
      }
      if (last) {
        gv0 = p0 >= 0 && p0 + g < P ? gr[p0 + g] : 0.0f;
        gv1 = p0 >= 0 && p0 + g + 8 < P ? gr[p0 + g + 8] : 0.0f;
      }
    };
    prefetch(-r);
    for (int tick = 0;; ++tick) {
      int f, b;
      bool fv, bv;
      item_flags(tick, f, b, fv, bv);
      if (bv && desc[b % DR].chunk != cur) {
        if (cur >= 0) flush(cur);
        cur = desc[b % DR].chunk;
      }
      // ---- forward of item f: a_{r+1} to block r + 1 (the last block: a_C
      // and the head, dz_C = bf16(w_out g) where a_C > 0, for the next tick)
      if (fv) {
        uint32_t a[F / 16][4];
        if (first) {
          uint32_t ax[1][4] = {{pack2(xv[0], xv[1]), pack2(xv[2], xv[3]), 0u, 0u}};
          float acc0[F / 8][4];
          wg_layer<F, 1, false>(acc0, ax, s_win);
          bias_relu_pack<F>(a, acc0, bias0);
        } else {
          // a_r of item f, copied in by block r - 1 last tick
          if (tid == 0) oc_mbar_expect(bar_a(f % S), SLOT);
          oc_mbar_wait(bar_a(f % S), (f / S) & 1);
          const unsigned char* in = slots + (f % S) * SLOT;
#pragma unroll
          for (int kt = 0; kt < F / 16; ++kt)
            ldsm_x4(a[kt], in + oc_off<F>(16 * wiw + (lane & 15), kt * 16 + (lane >> 4) * 8));
        }
        float acc[F / 8][4];
        wg_layer<F, F / 16, true>(acc, a, s_w);
        if (last)
          oc_fwd_epilogue<F, true>(acc, bias1, wo, gv0, gv1, anh + (f & 1) * SLOT,
                                   dzb + (f & 1) * SLOT, mrow, mcol);
        else
          oc_fwd_epilogue<F, false>(acc, bias1, wo, gv0, gv1, stage_a, nullptr, mrow, mcol);
        if (last) {
          if (t == 0) {
            gs[(f & 1) * OC_ROWS + r0] = gv0;
            gs[(f & 1) * OC_ROWS + r1] = gv1;
          }
          // dz_C reaches the next tick's wgmma reads (async proxy), and a_C,
          // dz_C and g the other warpgroups' reads
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("fence.acq_rel.cta;\n" ::: "memory");
        } else {
          // the warpgroup's a_{r+1} to block r + 1 by one bulk copy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          oc_bar_sync(1, 128);
          if (tid == 0)
            oc_bulk_copy(oc_mapa(smem_u32(slots + (f % S_next) * SLOT), r + 1), smem_u32(stage_a),
                         SLOT, oc_mapa(bar_a(f % S_next), r + 1));
        }
      }
      if (bv) {
        // db_{r+1} += 1^T dz_{r+1} by mma.sync with an all-ones A
        // (wgrad_kernel's k-steps, a tile each)
        const unsigned char* dzin = dzb + (b & 1) * SLOT;
        if (!last) oc_mbar_wait(bar_dz(b & 1), (b >> 1) & 1);  // dz_{r+1}, copied in
#pragma unroll
        for (int kt = 0; kt < OC_ROWS / 16; ++kt) {
#pragma unroll
          for (int j = 0; j < NPW; ++j) {
            uint32_t bb[4];
            ldsm_x4(bb, dzin + oc_dzt_off<F>((NPW * wiw + j) * 16 + (mi >> 1) * 8 + rr,
                                             kt * 16 + (mi & 1) * 8));
            mma(dbs[2 * j], ones, bb[0], bb[1]);
            mma(dbs[2 * j + 1], ones, bb[2], bb[3]);
          }
        }
        if (last && tid == 0) {  // db_out: wgrad_kernel's line, the item's rows in order
          const float* gb = gs + (b & 1) * OC_ROWS;
          for (int p = 0; p < OC_ROWS; ++p) hs += gb[p];
        }
      }
      prefetch(f + 1);
      if (tid == 0 && !last) oc_bulk_wait_read();  // stage_a is written again next tick
      oc_tick_barrier();
      if (done(tick)) break;
    }
    if (cur >= 0) flush(cur);
  } else if (wg == 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n");
    // block 0: dW_0 and db_0 of n-pairs NPW wiw ..
    float dw0[2 * NPW][4], db0[2 * NPW][4];
#pragma unroll
    for (int j = 0; j < 2 * NPW; ++j) {
      dw0[j][0] = dw0[j][1] = dw0[j][2] = dw0[j][3] = 0.0f;
      db0[j][0] = db0[j][1] = db0[j][2] = db0[j][3] = 0.0f;
    }
    auto flush = [&](int ci) {
      float* part = partials + size_t(ci) * stride;
#pragma unroll
      for (int e = 0; e < 2 * NPW; ++e) {
        const int c = (2 * NPW * wiw + e) * 8 + 2 * t;
        if (first) {
          part[GL.w_in + size_t(g) * F + c] = dw0[e][0];
          part[GL.w_in + size_t(g) * F + c + 1] = dw0[e][1];
          part[GL.w_in + size_t(g + 8) * F + c] = dw0[e][2];
          part[GL.w_in + size_t(g + 8) * F + c + 1] = dw0[e][3];
          if (g == 0) {
            part[GL.b + c] = db0[e][0];
            part[GL.b + c + 1] = db0[e][1];
          }
        }
        dw0[e][0] = dw0[e][1] = dw0[e][2] = dw0[e][3] = 0.0f;
        db0[e][0] = db0[e][1] = db0[e][2] = db0[e][3] = 0.0f;
      }
    };
    float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // block 0: x of this warp's tile of item b
    auto prefetch = [&](int i) {
      const long long p0 = p0_of(i);
      xv[0] = xv[1] = xv[2] = xv[3] = 0.0f;
      if (p0 >= 0) wg_load_x(xv, x, p0, P);
    };
    if (first) prefetch(-(2 * C - 1));
    for (int tick = 0;; ++tick) {
      int f, b;
      bool fv, bv;
      item_flags(tick, f, b, fv, bv);
      if (bv && desc[b % DR].chunk != cur) {
        if (cur >= 0) flush(cur);
        cur = desc[b % DR].chunk;
      }
      if (bv) {
        const unsigned char* dzin = dzb + (b & 1) * SLOT;
        const unsigned char* ain = first ? slots : slots + (b % S) * SLOT;
        if (first) {
          // a_0 of item b again, for dW_1's A (warpgroup 2), the mask of
          // dz_0 and bf16(x) for dW_0
          uint32_t ax[1][4] = {{pack2(xv[0], xv[1]), pack2(xv[2], xv[3]), 0u, 0u}};
          uint32_t a[F / 16][4];
          float acc0[F / 8][4];
          wg_layer<F, 1, false>(acc0, ax, s_win);
          bias_relu_pack<F>(a, acc0, bias0);
#pragma unroll
          for (int kt = 0; kt < F / 16; ++kt)
            stsm_x4(slots + oc_off<F>(mrow, kt * 16 + mcol), a[kt][0], a[kt][1], a[kt][2],
                    a[kt][3]);
          if (t < 2) {
            *reinterpret_cast<uint32_t*>(xs + (r0 * ldin(KIN) + 2 * t) * sizeof(bf16)) = ax[0][0];
            *reinterpret_cast<uint32_t*>(xs + (r1 * ldin(KIN) + 2 * t) * sizeof(bf16)) = ax[0][1];
          }
          oc_bar_arrive(2, 256);
        }
        // ---- dh_r = dz_{r+1} W (wgmma, W as the transposed B), masked by
        // a_r > 0 (read at each thread's fragment places), rounded to bf16:
        // dz_r, to block r - 1 (block 0 keeps dz_0)
        if (!last) {  // dz_{r+1} of item b, copied in by block r + 1 last tick
          if (tid == 128) oc_mbar_expect(bar_dz(b & 1), SLOT);
          oc_mbar_wait(bar_dz(b & 1), (b >> 1) & 1);
        }
        {
          uint32_t a[F / 16][4];
#pragma unroll
          for (int kt = 0; kt < F / 16; ++kt)
            ldsm_x4_t(a[kt],
                      dzin + oc_dzt_off<F>(kt * 16 + (mi >> 1) * 8 + rr, 16 * wiw + (mi & 1) * 8));
          float acc[F / 8][4];
          oc_layer_tb<F>(acc, a, s_w);
          unsigned char* dst = first ? dz0 : stage_dz;
          __syncwarp();  // block 0: the warp's a_0 rows, stored above
#pragma unroll
          for (int np = 0; np < F / 16; ++np) {
            uint32_t m[4], d[4];
            ldsm_x4(m, ain + oc_off<F>(mrow, np * 16 + mcol));  // a_r at the fragment's places
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int nt = 2 * np + e;
              const float2 m0v = unpack2(m[2 * e]), m1v = unpack2(m[2 * e + 1]);
              d[2 * e] = pack2(m0v.x > 0.0f ? acc[nt][0] : 0.0f, m0v.y > 0.0f ? acc[nt][1] : 0.0f);
              d[2 * e + 1] =
                  pack2(m1v.x > 0.0f ? acc[nt][2] : 0.0f, m1v.y > 0.0f ? acc[nt][3] : 0.0f);
            }
            stsm_x4_t(dst + oc_dzt_off<F>(np * 16 + mcol + rr, 16 * wiw + (mi & 1) * 8), d[0],
                      d[1], d[2], d[3]);
          }
          if (!first) {
            // the warpgroup's dz_r to block r - 1 by one bulk copy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            oc_bar_sync(3, 128);
            if (tid == 128)
              oc_bulk_copy(oc_mapa(smem_u32(dzb + (b & 1) * SLOT), r - 1), smem_u32(stage_dz),
                           SLOT, oc_mapa(bar_dz(b & 1), r - 1));
          }
        }
        if (first) {
          oc_bar_arrive(4, 256);  // dz_0 to warpgroup 2 (dx)
          oc_bar_sync(3, 128);    // dz_0 and bf16(x) of the warpgroup
          // dW_0 += bf16(x)^T dz_0 and db_0 += 1^T dz_0 (mma.sync)
#pragma unroll
          for (int kt = 0; kt < OC_ROWS / 16; ++kt) {
            uint32_t ax[4];
            ldsm_x4_t(ax, xs + ((kt * 16 + (mi >> 1) * 8 + rr) * ldin(KIN) + (mi & 1) * 8) *
                                   sizeof(bf16));
#pragma unroll
            for (int j = 0; j < NPW; ++j) {
              uint32_t bb[4];
              ldsm_x4(bb, dz0 + oc_dzt_off<F>((NPW * wiw + j) * 16 + (mi >> 1) * 8 + rr,
                                              kt * 16 + (mi & 1) * 8));
              mma(dw0[2 * j], ax, bb[0], bb[1]);
              mma(dw0[2 * j + 1], ax, bb[2], bb[3]);
              mma(db0[2 * j], ones, bb[0], bb[1]);
              mma(db0[2 * j + 1], ones, bb[2], bb[3]);
            }
          }
        }
      }
      if (first) prefetch(b + 1);
      if (tid == 128 && !first) oc_bulk_wait_read();  // stage_dz is written again next tick
      oc_tick_barrier();
      if (done(tick)) break;
    }
    if (cur >= 0) flush(cur);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    // dW_{r+1} rows 64 mh + 16 wiw .. and, on the last block, dw_out[tid - 256]
    float dw[F / 64][F / 8][4];
#pragma unroll
    for (int mh = 0; mh < F / 64; ++mh)
#pragma unroll
      for (int j = 0; j < F / 8; ++j)
        dw[mh][j][0] = dw[mh][j][1] = dw[mh][j][2] = dw[mh][j][3] = 0.0f;
    float hs = 0.0f;
    auto flush = [&](int ci) {
      float* part = partials + size_t(ci) * stride;
      float* G = part + GL.w_hid + size_t(r) * F * F;
#pragma unroll
      for (int mh = 0; mh < F / 64; ++mh) {
        const int m = mh * 64 + r0;
#pragma unroll
        for (int nt = 0; nt < F / 8; ++nt) {
          const int c = nt * 8 + 2 * t;
          G[m * F + c] = dw[mh][nt][0];
          G[m * F + c + 1] = dw[mh][nt][1];
          G[(m + 8) * F + c] = dw[mh][nt][2];
          G[(m + 8) * F + c + 1] = dw[mh][nt][3];
          dw[mh][nt][0] = dw[mh][nt][1] = dw[mh][nt][2] = dw[mh][nt][3] = 0.0f;
        }
      }
      if (last && tid - 256 < F) part[GL.w_out + tid - 256] = hs;
      hs = 0.0f;
    };
    for (int tick = 0;; ++tick) {
      int f, b;
      bool fv, bv;
      item_flags(tick, f, b, fv, bv);
      if (bv && desc[b % DR].chunk != cur) {
        if (cur >= 0) flush(cur);
        cur = desc[b % DR].chunk;
      }
      if (bv) {
        // ---- dW_{r+1} += a_r^T dz_{r+1}: each 64-row half of the inputs,
        // four wgmma k-steps of a tile's 16 points each (wgrad_kernel's
        // order), A = a_r^T by ldmatrix.trans, B the dz^T slot
        const unsigned char* ain = first ? slots : slots + (b % S) * SLOT;
        const uint32_t bdz = smem_u32(dzb + (b & 1) * SLOT);
        if (!last) oc_mbar_wait(bar_dz(b & 1), (b >> 1) & 1);  // dz_{r+1}, copied in
        if (first) oc_bar_sync(2, 256);  // a_0 of item b, stored by warpgroup 1
#pragma unroll
        for (int mh = 0; mh < F / 64; ++mh) {
          uint32_t af[OC_ROWS / 16][4];
#pragma unroll
          for (int kt = 0; kt < OC_ROWS / 16; ++kt)
            ldsm_x4_t(af[kt], ain + oc_off<F>(kt * 16 + (mi >> 1) * 8 + rr,
                                              mh * 64 + 16 * wiw + (mi & 1) * 8));
          wg_pin(dw[mh]);
          wg_pin(af);
          wgmma_fence();
#pragma unroll
          for (int kt = 0; kt < OC_ROWS / 16; ++kt)
            wgmma_rs<F>(dw[mh], af[kt], wg_kstep_desc<true>(bdz, kt, OC_ROWS, F), 1);
          wgmma_commit();
          wgmma_wait();
          wg_pin(dw[mh]);
          wg_pin(af);
        }
        if (first) {
          oc_bar_sync(4, 256);  // dz_0 of item b, stored by warpgroup 1
          // dx = dz_0 W_in (f32), the chain's lines, a warp a tile
          const long long p0 = p0_of(b);
          if (p0 >= 0 && dx.dx) {
            // warp_mm_t<F / 16, 2>'s k-steps, each A fragment loaded at its step
            float accx[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) accx[nt][0] = accx[nt][1] = accx[nt][2] = accx[nt][3] = 0.0f;
#pragma unroll
            for (int kt = 0; kt < F / 16; ++kt) {
              uint32_t a[4], bw[4];
              ldsm_x4_t(a, dz0 + oc_dzt_off<F>(kt * 16 + (mi >> 1) * 8 + rr, 16 * wiw + (mi & 1) * 8));
              ldsm_x4_t(bw, winc + (kt * 16 + (mi & 1) * 8 + rr) * ldin(KIN) + (mi >> 1) * 8);
              mma(accx[0], a, bw[0], bw[1]);
              mma(accx[1], a, bw[2], bw[3]);
            }
            const long long q0 = p0 + g, q1 = q0 + 8;
            if (t < 2) {
              if (q0 < P) {
                dx.dx[q0 * dx.sp + 2 * t * dx.sc] = accx[0][0];
                if (t == 0) dx.dx[q0 * dx.sp + dx.sc] = accx[0][1];
              }
              if (q1 < P) {
                dx.dx[q1 * dx.sp + 2 * t * dx.sc] = accx[0][2];
                if (t == 0) dx.dx[q1 * dx.sp + dx.sc] = accx[0][3];
              }
            }
          }
        }
        if (last && tid - 256 < F) {
          // dw_out: wgrad_kernel's line, the item's rows in order
          const unsigned char* ab = anh + (b & 1) * SLOT;
          const float* gb = gs + (b & 1) * OC_ROWS;
          const int c = tid - 256;
          for (int p = 0; p < OC_ROWS; ++p)
            hs += __bfloat162float(*reinterpret_cast<const bf16*>(ab + oc_off<F>(p, c))) * gb[p];
        }
      }
      if (scanner) {
        oc_post(cluster, desc, (tick + 2) % DR, oc_next_item(sc, x, P, chunk, n_chunks, n_active),
                C);
        oc_scan_prefetch(sc, x, P, chunk, n_chunks);
      }
      oc_tick_barrier();
      if (done(tick)) break;
    }
    if (cur >= 0) flush(cur);
    if (scanner && lane == 0 && tiles_done) atomicAdd(tiles_done, (unsigned long long)n_active);
  }
}

// kernel #2 on chip over P points (oc_dims_ok(F, nh)), then the chunks'
// partials summed in chunk order
template <int F, class X>
int launch_onchip_bwd(const X& x, const float* g, long long P, const Params& prm, int nh,
                      const DxOut& dx, const BwdScratch& s, float* grads, cudaStream_t st,
                      unsigned long long* tiles_done) {
  const GradLayout GL = grad_layout(F, nh);
  if (P > 0) {
    const size_t smem = oc_layout(F, nh).total;
    cudaError_t e = cudaFuncSetAttribute(onchip_bwd_kernel<F, X>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)nh;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)nh);
    cfg.blockDim = dim3(OC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_cl = 0;
    e = cudaOccupancyMaxActiveClusters(&n_cl, onchip_bwd_kernel<F, X>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n_cl <= 0) return (int)cudaErrorInvalidConfiguration;
    n_cl = std::min(n_cl, s.n_chunks);
    cfg.gridDim = dim3((unsigned)(n_cl * nh));
    e = cudaLaunchKernelEx(&cfg, onchip_bwd_kernel<F, X>, x, g, P, prm, nh, s.chunk, s.n_chunks,
                           s.partials, (long long)GL.stride, dx, tiles_done);
    if (e != cudaSuccess) return (int)e;
  }
  const int rt = 256;
  reduce_partials<<<(unsigned)((GL.n + rt - 1) / rt), rt, 0, st>>>(
      s.partials, P > 0 ? s.n_chunks : 0, (long long)GL.stride, (long long)GL.n, grads);
  return (int)cudaGetLastError();
}

}  // namespace
