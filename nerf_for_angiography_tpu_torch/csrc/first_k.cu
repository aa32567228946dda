// First-k-active compaction for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel nerf_for_angiography_tpu/ops/pallas/first_k.py
// `_fka_kernel_t` (line 50, launched by `first_k_active_pallas`, line 71).
//
// Function. For each row r of a {0,1} float mask (R, w), with rank the
// inclusive running count of active samples:
//   sel[r, j]    = min(#{s : rank[r, s] <= j}, w - 1)   (int32, (R, k))
//   mask_k[r, j] = j < rank[r, w - 1] ? 1 : 0           (float, (R, k))
// i.e. sel[r, j] is the index of the (j+1)-th active sample of the row and
// every slot past the row's active count holds w - 1 with mask_k 0. k may
// exceed w.
//
// Bound. Pure data movement: the row is read once (4 w bytes, fewer when
// the k-th active sample comes early) and 8 k bytes are written per row;
// at (5,625, 300, 96) that is 6.75 MB + 4.32 MB, about 3.3 us at 3.35 TB/s.
// Launch overhead dominates a call at every shape of the training path.
//
// Design. The TPU kernel puts rays in lanes and loops w x k compares (the
// (8, 128) vector unit has no cheap scan). Here the natural form is a scan
// and a scatter: one warp per row reads 32 samples at a time (coalesced),
// takes the warp's ballot of active lanes and each active lane's exclusive
// count below it (`__popc` of the ballot under the lane mask), so each
// active sample knows its 0-based rank r exactly in integers, and writes
// sel[r] = s when r < k. The warp stops reading once k actives are found.
// Slots past the row's count get w - 1, and mask_k is written from the
// count. O(w) work per row against the TPU's O(w k); integer counts, so the
// result is exact for any w (the f32 cumsum of the TPU wrapper is exact only
// below 2^24). No shared memory, no block barrier; 8 rows per 256-thread
// block.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
first_k_kernel(const float* __restrict__ mask, long long rows, int w, int k,
               int* __restrict__ sel, float* __restrict__ mask_k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: one row per warp
  const float* m = mask + row * (long long)w;
  int* s_out = sel + row * (long long)k;
  float* mk_out = mask_k + row * (long long)k;
  const unsigned below = (1u << lane) - 1u;  // lanes strictly below this one

  int total = 0;  // actives seen so far (warp-uniform)
  for (int base = 0; base < w && total < k; base += 32) {
    const int s = base + lane;
    const bool active = s < w && m[s] != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (active) {
      const int r = total + __popc(ballot & below);  // 0-based rank
      if (r < k) s_out[r] = s;
    }
    total += __popc(ballot);
  }
  // total >= k here only if the loop stopped early; either way slots
  // [min(total, k), k) are empty
  const int filled = total < k ? total : k;
  for (int j = filled + lane; j < k; j += 32) s_out[j] = w - 1;
  for (int j = lane; j < k; j += 32) mk_out[j] = j < total ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int first_k_active_launch(const void* mask, long long rows, int w, int k,
                                     void* sel, void* mask_k, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  first_k_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)mask, rows, w, k, (int*)sel, (float*)mask_k);
  return (int)cudaGetLastError();
}
