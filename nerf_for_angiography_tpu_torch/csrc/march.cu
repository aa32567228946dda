// The compacted march for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package marches with XLA op chains
// (nerf_for_angiography_tpu/ops/occupancy.py), and the port ran the same
// chain as ~200 small PyTorch ops a two-bucket march (ops/occupancy.py,
// which keeps it as the plain version for the CPU and the tests). Three
// kernels take its place on the card: a step's march is one launch (the
// lattice, hybrid and window marches) or three (the two-bucket marches:
// the coarse windows, the sort, the fine march). #5's first-k
// (csrc/first_k.cu) is fused into the fine kernel.
//
// Function. Per ray, the slab ray/AABB test; for every mode but the
// lattice, the conservative coarse window over the dilated coarse table
// (ops/occupancy.py::coarse_window: strided probes, first and last hit,
// start_idx, end_idx, any_hit). Then over the ray's candidate window of W
// lattice samples starting at w (the lattice: w = 0, W = n_samples; the
// hybrid: w = the window start clamped so the window stays on the lattice)
// the active mask: in the box, occupied (the fine grid probed every
// occ_stride-th sample, a sample occupied where either bracketing probe
// hits) and, but on the lattice, any_hit; and of the actives the first k,
// written as t_starts, t_ends, positions and mask_k, slots past the ray's
// active count holding the window's last sample with mask_k 0, as #5's sel
// does; active_count counts every active of the window, edge_active flags
// an active last sample of a window that stops short of the lattice end.
// The window march writes its k consecutive samples from the clamped window
// start, masked by the box, end_idx and any_hit. The two-bucket marches
// first sort the rays by window span (a stable counting sort, span in
// [0, n_samples]): perm equals torch.argsort(span, stable=True) and
// inv[perm[j]] = j; the fine kernel marches row j on ray perm[j], the rows
// below the cut at (w_lo, k_lo), the rest at (w_cap, k).
//
// Same bits as the op chain. Every float is formed by the chain's formula
// in the chain's order with __fadd_rn / __fmul_rn / __fdiv_rn, no
// contraction: the window and coarse probes' midpoints near + (i + 0.5)
// step, the lattice mask's (t_start + t_end) / 2, the outputs' t_start +
// step / 2; the table lookup (p - lo) / (hi - lo) * res, truncated and
// clamped; the box test's 1e-10 guard and reciprocal. Counts are integers.
//
// Bound. Bytes: each written point is a position, t_start, t_end and mask,
// 24 B; at CT's two-bucket Tuning (5,625 rays, ~94 points a ray) 12.7 MB a
// step, about 4 us at 3.35 TB/s. The reads (origins, directions, the grid
// tables, ~2 MB of bits that stay in L2) are smaller. The chain took ~0.57
// ms in launches of small ops; the kernels' time is launch latency, the
// warps' serial walk over a window and the one-block sort.
//
// Design. One warp a ray, 8 rays a block, no block barrier but in the
// sort. A window is walked 32 samples at a time: for occ_stride s > 1 the
// lanes first probe the (at most 17) strided samples a chunk needs and
// share the hits by ballot; each active lane's rank is its ballot's
// population below it, so the first k actives go straight to their slots.
// The front kernel finds each ray's coarse window with one probe a lane
// (ballot, first and last set bit) and writes its span; the sort kernel, one
// block, then sorts the spans: per-warp histograms of contiguous ray
// segments in shared memory, their offsets, a block scan over the bins, then
// each warp places its segment in order, ranking equal keys within 32 rays
// by __match_any_sync, so equal spans keep their input order.

#include <cuda_runtime.h>

// The launch arguments, structs of the C interface (outside the anonymous
// namespace, which would give the exported functions internal linkage).

// one bucket's outputs, rows x k slots (positions rows x k x 3), and its
// window width
struct MarchBucket {
  float* ts;
  float* te;
  float* pos;
  float* mask;
  int* count;
  unsigned char* edge;
  int w;
  int k;
};

// the order and types of ops/kernels/march.py::_Args
struct MarchArgs {
  const float* o;              // (rays, 3)
  const float* d;              // (rays, 3)
  const float* aabb;           // (6,) [min xyz, max xyz]
  const unsigned char* bits;   // (res,)^3 occupancy
  const unsigned char* coarse; // (cres,)^3 dilated coarse table; null on the lattice
  const long long* perm;       // two buckets: row j marches ray perm[j]; null: ray j
  const int* start;            // two buckets: each ray's window start (front kernel)
  const unsigned char* hit;    // two buckets: each ray's any_hit (front kernel)
  MarchBucket b[2];            // rows [0, cut) and [cut, rows)
  int rows;
  int cut;
  int scatter;                 // 1: row j's output row is perm[j] (both buckets one set)
  int mode;
  int n;
  int res;
  int cres;
  int occ_stride;
  int c_stride;
  int c_slack;
  int c_nprobe;
  float near;
  float step;
  float half_step;
};

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kLattice = 0, kHybrid = 1, kWindow = 2 };

struct Box {
  float lo[3], hi[3], ext[3];
};

__device__ __forceinline__ Box load_box(const float* aabb) {
  Box b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.lo[a] = aabb[a];
    b.hi[a] = aabb[3 + a];
    b.ext[a] = __fsub_rn(b.hi[a], b.lo[a]);
  }
  return b;
}

__device__ __forceinline__ void load_ray(const MarchArgs& a, long long ray, float o[3],
                                         float d[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = a.o[3 * ray + c];
    d[c] = a.d[3 * ray + c];
  }
}

// o + d t, component by component
__device__ __forceinline__ void point_at(const float o[3], const float d[3], float t, float p[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(o[c], __fmul_rn(d[c], t));
}

// _query_bits: the table's bit at a world point, false outside the box
__device__ __forceinline__ bool query(const unsigned char* table, int res, const Box& b,
                                      const float p[3]) {
  int cell = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!(p[c] >= b.lo[c] && p[c] <= b.hi[c])) return false;
    // inside the box the scaled coordinate lies in [0, res]
    const float norm = __fdiv_rn(__fsub_rn(p[c], b.lo[c]), b.ext[c]);
    const int i = __float2int_rz(__fmul_rn(norm, (float)res));
    cell = cell * res + min(max(i, 0), res - 1);
  }
  return table[cell] != 0;
}

// ray_aabb_intersect: the slab method, |d| under 1e-10 replaced by 1e-10
__device__ __forceinline__ void ray_box(const Box& b, const float o[3], const float d[3],
                                        float& t_in, float& t_out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dc = fabsf(d[c]) < 1e-10f ? 1e-10f : d[c];
    const float inv = __fdiv_rn(1.0f, dc);
    const float t0 = __fmul_rn(__fsub_rn(b.lo[c], o[c]), inv);
    const float t1 = __fmul_rn(__fsub_rn(b.hi[c], o[c]), inv);
    t_in = c ? fmaxf(t_in, fminf(t0, t1)) : fminf(t0, t1);
    t_out = c ? fminf(t_out, fmaxf(t0, t1)) : fmaxf(t0, t1);
  }
}

// near + (i + 0.5) step: the coarse probes' and the hybrid window's midpoints
__device__ __forceinline__ float mid_half(const MarchArgs& a, int i) {
  return __fadd_rn(a.near, __fmul_rn(__fadd_rn((float)i, 0.5f), a.step));
}

// (t_start + t_end) / 2 of lattice sample i: march_rays' mask
__device__ __forceinline__ float mid_lattice(const MarchArgs& a, int i) {
  const float ts = __fadd_rn(a.near, __fmul_rn((float)i, a.step));
  return __fdiv_rn(__fadd_rn(ts, __fadd_rn(ts, a.step)), 2.0f);
}

// _lattice_at's midpoint of lattice sample idx, t_start + step / 2
__device__ __forceinline__ float slot_mid(const MarchArgs& a, int idx) {
  return __fadd_rn(__fadd_rn(a.near, __fmul_rn((float)idx, a.step)), a.half_step);
}

// _lattice_at: slot j of an output row holds lattice sample idx
__device__ __forceinline__ void put_slot(const MarchArgs& a, const MarchBucket& bk,
                                         long long row, int j, int idx, float m,
                                         const float o[3], const float d[3]) {
  const float ts = __fadd_rn(a.near, __fmul_rn((float)idx, a.step));
  const long long s = row * bk.k + j;
  bk.ts[s] = ts;
  bk.te[s] = __fadd_rn(ts, a.step);
  bk.mask[s] = m;
  float p[3];
  point_at(o, d, __fadd_rn(ts, a.half_step), p);
  float* out = bk.pos + 3 * s;
  out[0] = p[0];
  out[1] = p[1];
  out[2] = p[2];
}

// coarse_window for one ray, one probe a lane: (start, end, hit), warp-uniform
__device__ __forceinline__ void coarse_window(const MarchArgs& a, const Box& box,
                                              const float o[3], const float d[3], int lane,
                                              int& start, int& end, bool& hit) {
  int first = -1, last = -1;
  for (int base = 0; base < a.c_nprobe; base += 32) {
    const int p = base + lane;
    bool h = false;
    if (p < a.c_nprobe) {
      float x[3];
      point_at(o, d, mid_half(a, min(p * a.c_stride, a.n - 1)), x);
      h = query(a.coarse, a.cres, box, x);
    }
    const unsigned bal = __ballot_sync(kFull, h);
    if (bal) {
      if (first < 0) first = base + __ffs(bal) - 1;
      last = base + 31 - __clz(bal);
    }
  }
  hit = first >= 0;
  // rows without a hit: argmax gives 0 for the first probe, the last probe
  // for the last
  const int first_p = hit ? first : 0;
  const int last_p = hit ? last : a.c_nprobe - 1;
  start = max((first_p - 1) * a.c_stride + a.c_slack, 0);
  const int end_raw = (last_p + 1) * a.c_stride + (a.c_stride - 1) - a.c_slack;
  end = last_p >= a.c_nprobe - 1 ? a.n - 1 : min(end_raw, a.n - 1);
}

// march_rays_window: k consecutive samples from the clamped window start
__device__ __forceinline__ void window_row(const MarchArgs& a, const MarchBucket& bk,
                                           long long row, int lane, const float o[3],
                                           const float d[3], float t_in, float t_out, int start,
                                           int end, bool hit) {
  const int k = bk.k;
  const int w = min(max(start, 0), max(a.n - k, 0));
  int total = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    bool act = false;
    if (j < k) {
      const int idx = w + j;
      const float tm = slot_mid(a, idx);
      act = tm >= t_in && tm <= t_out && idx <= end && hit;
      put_slot(a, bk, row, j, idx, act ? 1.0f : 0.0f, o, d);
    }
    total += __popc(__ballot_sync(kFull, act));
  }
  if (lane == 0) {
    bk.count[row] = total;
    bk.edge[row] = hit && end > w + (k - 1);
  }
}

// march_rays(compact_k) and _hybrid_fine: the strided fine mask over the
// window and its first k actives
__device__ __forceinline__ void first_k_row(const MarchArgs& a, const MarchBucket& bk,
                                            long long row, int lane, const float o[3],
                                            const float d[3], const Box& box, float t_in,
                                            float t_out, int start, bool hit) {
  const bool lattice = a.mode == kLattice;
  const int W = bk.w, k = bk.k;
  const int w = lattice ? 0 : min(max(start, 0), max(a.n - W, 0));
  const int s = a.occ_stride > 1 ? a.occ_stride : 1;
  const int n_probe = (W + s - 1) / s;
  const unsigned below = (1u << lane) - 1u;
  int total = 0;          // actives so far (warp-uniform)
  bool last_act = false;  // the window's last sample is active
  // a ray without a coarse hit has no active sample
  for (int base = 0; hit && base < W; base += 32) {
    const int i = base + lane;
    // the chunk's strided probes: samples base / s + lane of the probe row
    // (a chunk of 32 samples needs at most 17 of them for s >= 2)
    const int q0 = base / s;
    unsigned probes = 0;
    if (s > 1) {
      const int q = q0 + lane;
      bool h = false;
      if (q < n_probe) {
        const int r = q * s;
        float x[3];
        point_at(o, d, lattice ? mid_lattice(a, r) : mid_half(a, w + r), x);
        h = query(a.bits, a.res, box, x);
      }
      probes = __ballot_sync(kFull, h);
    }
    bool act = false;
    if (i < W) {
      const float t = lattice ? mid_lattice(a, i) : mid_half(a, w + i);
      if (t >= t_in && t <= t_out) {
        if (s > 1) {
          const int q = i / s, q2 = min(q + 1, n_probe - 1);
          act = ((probes >> (q - q0)) | (probes >> (q2 - q0))) & 1u;
        } else {
          float x[3];
          point_at(o, d, t, x);
          act = query(a.bits, a.res, box, x);
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, act);
    if (act) {
      const int r = total + __popc(bal & below);  // 0-based rank
      if (r < k) put_slot(a, bk, row, r, w + i, 1.0f, o, d);
    }
    if (W - 1 - base < 32) last_act = (bal >> (W - 1 - base)) & 1u;
    total += __popc(bal);
  }
  // slots past the actives: the window's last sample, mask 0
  for (int j = min(total, k) + lane; j < k; j += 32) put_slot(a, bk, row, j, w + W - 1, 0.0f, o, d);
  if (lane == 0) {
    bk.count[row] = total;
    bk.edge[row] = last_act && !lattice && w + W < a.n;
  }
}

__global__ void __launch_bounds__(kWarps * 32) march_fine_kernel(const MarchArgs a) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= a.rows) return;  // uniform across the warp: one row a warp
  const int bi = j >= a.cut ? 1 : 0;
  const MarchBucket bk = bi ? a.b[1] : a.b[0];
  const long long ray = a.perm ? a.perm[j] : j;
  const long long row = a.scatter ? ray : j - (bi ? a.cut : 0);
  float o[3], d[3];
  load_ray(a, ray, o, d);
  const Box box = load_box(a.aabb);
  float t_in, t_out;
  ray_box(box, o, d, t_in, t_out);
  int start = 0, end = a.n - 1;
  bool hit = true;
  if (a.mode != kLattice) {
    if (a.start) {
      start = a.start[ray];
      hit = a.hit[ray] != 0;
    } else {
      coarse_window(a, box, o, d, lane, start, end, hit);
    }
  }
  if (a.mode == kWindow) {
    window_row(a, bk, row, lane, o, d, t_in, t_out, start, end, hit);
  } else {
    first_k_row(a, bk, row, lane, o, d, box, t_in, t_out, start, hit);
  }
}

// exclusive prefix sum over the block (kWarps warps); ws holds kWarps ints
__device__ __forceinline__ int block_exclusive_sum(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? ws[lane] : 0;
    int u = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, u, off);
      if (lane >= off) u += y;
    }
    if (lane < kWarps) ws[lane] = u - t;
  }
  __syncthreads();
  return ws[warp] + x - v;
}

// the stable counting sort of span (rays keys in [0, n]) by one block:
// perm[pos] = i, inv[i] = pos; sort_warps warps own contiguous segments
__device__ void counting_sort(const int* span, int rays, int n, int sort_warps, long long* perm,
                              long long* inv, int* smem) {
  const int bins = n + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* hist = smem;                        // sort_warps x bins: counts, then offsets
  int* offset = hist + sort_warps * bins;  // bins: the bins' starts
  int* ws = offset + bins;                 // kWarps
  for (int x = threadIdx.x; x < sort_warps * bins; x += blockDim.x) hist[x] = 0;
  __syncthreads();
  const int seg = (rays + sort_warps - 1) / sort_warps;
  const int a0 = min(warp * seg, rays), a1 = min(a0 + seg, rays);
  auto key = [&](int i) { return min(max(span[i], 0), n); };
  if (warp < sort_warps)
    for (int i = a0 + lane; i < a1; i += 32) atomicAdd(&hist[warp * bins + key(i)], 1);
  __syncthreads();
  // per bin: each warp's start among the bin's rays, and the bin's size
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    int run = 0;
    for (int w = 0; w < sort_warps; ++w) {
      const int c = hist[w * bins + b];
      hist[w * bins + b] = run;
      run += c;
    }
    offset[b] = run;
  }
  __syncthreads();
  // the bins' starts: each thread a contiguous run of bins
  const int per = (bins + blockDim.x - 1) / blockDim.x;
  const int b0 = min((int)threadIdx.x * per, bins), b1 = min(b0 + per, bins);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += offset[b];
  int run = block_exclusive_sum(sum, ws);
  for (int b = b0; b < b1; ++b) {
    const int c = offset[b];
    offset[b] = run;
    run += c;
  }
  __syncthreads();
  if (warp >= sort_warps) return;
  for (int base = a0; base < a1; base += 32) {
    const int i = base + lane;
    const bool valid = i < a1;
    const unsigned vmask = __ballot_sync(kFull, valid);
    if (valid) {
      const int kk = key(i);
      const unsigned peers = __match_any_sync(vmask, kk);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int* slot = &hist[warp * bins + kk];
      const int pos = offset[kk] + *slot + rank;
      __syncwarp(vmask);
      if (rank == 0) *slot += __popc(peers);
      __syncwarp(vmask);
      perm[pos] = i;
      inv[i] = pos;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
march_front_kernel(const MarchArgs a, int* __restrict__ start, unsigned char* __restrict__ hit,
                   int* __restrict__ span) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray < a.rows) {
    float o[3], d[3];
    load_ray(a, ray, o, d);
    const Box box = load_box(a.aabb);
    int s, e;
    bool h;
    coarse_window(a, box, o, d, lane, s, e, h);
    if (lane == 0) {
      start[ray] = s;
      hit[ray] = h;
      span[ray] = h ? e - s + 1 : 0;
    }
  }
}

// one block: the stable counting sort of every ray's span
__global__ void __launch_bounds__(kWarps * 32)
march_sort_kernel(const int* __restrict__ span, int rays, int n, int sort_warps,
                  long long* __restrict__ perm, long long* __restrict__ inv) {
  extern __shared__ int smem[];
  counting_sort(span, rays, n, sort_warps, perm, inv, smem);
}

}  // namespace

extern "C" int march_fine_launch(const MarchArgs* args, void* stream) {
  if (args->rows <= 0) return 0;
  const long long blocks = (args->rows + kWarps - 1) / kWarps;
  march_fine_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int march_front_launch(const MarchArgs* args, void* start, void* hit, void* span,
                                  void* stream) {
  if (args->rows <= 0) return 0;
  const long long blocks = (args->rows + kWarps - 1) / kWarps;
  march_front_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      *args, (int*)start, (unsigned char*)hit, (int*)span);
  return (int)cudaGetLastError();
}

extern "C" int march_sort_launch(const void* span, int rays, int n, int sort_warps, void* perm,
                                 void* inv, void* stream) {
  if (rays <= 0) return 0;
  const size_t smem = sizeof(int) * ((size_t)(sort_warps + 1) * (n + 1) + kWarps);
  march_sort_kernel<<<1, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const int*)span, rays, n, sort_warps, (long long*)perm, (long long*)inv);
  return (int)cudaGetLastError();
}
