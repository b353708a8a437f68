// The candidate stage's slot budget and slot-to-key assignment: the
// shortest-first greedy budget over a (read, strand) row's keys, then each
// of the row's W slots given to the key whose site list covers it, one
// launch a batch and no host synchronisation.
//
// Replaces the JAX package's budget and slot assignment inside
// candidate_stage (bbmap_tpu/align/quickmap_device.py:1036-1104: a pairwise
// rank-sum at nk <= 64 or an argsort at the long nk, a cumsum, and an
// unrolled interval test or a counting search, all in the fused XLA
// program). The port ran it as eager tensor steps (_slot_pack_plain): a
// stable argsort, a gather, two cumsums, a scatter, a searchsorted and
// three gathers over (B, 2, nk) and (B, 2, W).
//
// The function, per row of nk keys (gadm the lengths the budget ranks by,
// cnt_local the lengths gathered, s0 the lists' first sites, offadj the
// keys' diagonal adjustments, admit the admission mask):
//
//   g1_j = gadm_j, or BIG where gadm_j == 0; key j precedes key k iff
//     (g1_j, j) < (g1_k, k); fits_k iff the sum of gadm over the keys at
//     or before k in that order is <= W (int32, wrapped as the eager
//     cumsum wraps)
//   cnt_k = cnt_local_k where admit_k, fits_k and gadm_k > 0, else 0;
//     cum the inclusive prefix sum of cnt in key order
//   slot w: t = min(#{t : cum_t <= w}, nk - 1) (searchsorted's upper
//     bound on the sorted cum); the gather index clamp(s0_t - cum_{t-1}
//     + w, 0, n_sites - 1); offadj_t; the key slot t; valid iff w <
//     cum_{nk-1}; the row total cum_{nk-1}
//
// The rank is a count, the JAX package's pairwise form: lane j sums gadm_k
// over every k that precedes it (nk compares a key), so no sort is needed
// and the argsort's and the rank-sum's fits are the same by construction.
//
// Design: a warp a row (blocks of kWarps warps). The row's lengths, then
// cum, the bases s0_t - cum_{t-1} and offadj sit in the warp's slice of
// shared memory, 16 B a key. The keys are taken in pieces of 32, a lane a
// key, with a warp sum and a carry for cum (nk is 18 at L = 150 and 750 at
// L = 6,000); the slots w = lane, lane + 32, ... each take a binary search
// of cum in shared memory.
//
// What bounds it: bytes. The (B, 2, nk) inputs are read once (17 B a key)
// and the (B, 2, W) outputs written once (17 B a slot: the int64 gather
// index, offadj, the key slot, the flag), ~149 MB at 65,536 reads of 150
// bp (nk 18, W 64). The rank's nk^2 compares a row are small beside that
// at nk = 18; at nk = 750 (32 reads a call) the work is latency on a few
// warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // rows a block
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90

__host__ __device__ inline size_t warp_bytes(int nk) {
  // gadm, cum, base and offadj: 4 B each a key
  return 16 * static_cast<size_t>(nk);
}

__device__ inline unsigned incl_sum(unsigned v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__global__ void slot_pack_kernel(
    const int* __restrict__ gadm, const int* __restrict__ cnt_local,
    const int* __restrict__ s0, const int* __restrict__ offadj,
    const uint8_t* __restrict__ admit, long long rows, int nk, int W,
    int max_idx, long long* __restrict__ gather_idx,
    int* __restrict__ offadj_slot, int* __restrict__ toff_slot,
    uint8_t* __restrict__ valid_slot, int* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= rows) return;
  int* g = reinterpret_cast<int*>(smem + warp * warp_bytes(nk));
  int* cum = g + nk;
  int* base = cum + nk;
  int* oa = base + nk;
  const long long at = r * nk;

  for (int j = lane; j < nk; j += 32) g[j] = gadm[at + j];
  __syncwarp();

  // the greedy budget by rank, then cum in pieces of 32 with a carry
  unsigned carry = 0;
  for (int p = 0; p < nk; p += 32) {
    const int j = p + lane;
    unsigned c = 0;
    if (j < nk) {
      const int gj = g[j];
      const int g1j = gj > 0 ? gj : kBig;
      unsigned csum = 0;
      for (int k = 0; k < nk; ++k) {
        const int gk = g[k];
        const int g1k = gk > 0 ? gk : kBig;
        if (g1k < g1j || (g1k == g1j && k <= j))
          csum += static_cast<unsigned>(gk);
      }
      const bool fits = static_cast<int>(csum) <= W;
      if (admit[at + j] && fits && gj > 0)
        c = static_cast<unsigned>(cnt_local[at + j]);
    }
    const unsigned v = incl_sum(c, lane) + carry;
    if (j < nk) cum[j] = static_cast<int>(v);
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();
  for (int j = lane; j < nk; j += 32) {
    const unsigned prev = j > 0 ? static_cast<unsigned>(cum[j - 1]) : 0u;
    base[j] = static_cast<int>(static_cast<unsigned>(s0[at + j]) - prev);
    oa[j] = offadj[at + j];
  }
  __syncwarp();

  const int tot = cum[nk - 1];
  const long long out = r * W;
  for (int w = lane; w < W; w += 32) {
    // upper bound: the first t with cum_t > w (torch.searchsorted's
    // right=True search)
    int lo = 0, hi = nk;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= w)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int t = min(lo, nk - 1);
    int idx = static_cast<int>(static_cast<unsigned>(base[t]) +
                               static_cast<unsigned>(w));
    idx = min(max(idx, 0), max_idx);
    gather_idx[out + w] = idx;
    offadj_slot[out + w] = oa[t];
    toff_slot[out + w] = t;
    valid_slot[out + w] = w < tot;
  }
  if (lane == 0) total[r] = tot;
}

}  // namespace

extern "C" {

// rows (read, strand) rows of nk keys: gadm, cnt_local, s0, offadj (rows,
// nk) int32 and admit (rows, nk) bool bytes, row-major. W slots a row;
// max_idx = the sites' count - 1. Out: gather_idx (rows, W) int64,
// offadj_slot and toff_slot (rows, W) int32, valid_slot (rows, W) bool
// bytes, total (rows,) int32. Past 227 KB of shared memory a block (nk ~
// 3,600) the launch returns cudaErrorInvalidValue.
cudaError_t slot_pack_launch(const int* gadm, const int* cnt_local,
                             const int* s0, const int* offadj,
                             const uint8_t* admit, long long rows, int nk,
                             int W, int max_idx, long long* gather_idx,
                             int* offadj_slot, int* toff_slot,
                             uint8_t* valid_slot, int* total,
                             cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (nk < 1 || W < 1) return cudaErrorInvalidValue;
  const size_t smem = kWarps * warp_bytes(nk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slot_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  slot_pack_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, smem,
                     stream>>>(gadm, cnt_local, s0, offadj, admit, rows, nk,
                               W, max_idx, gather_idx, offadj_slot,
                               toff_slot, valid_slot, total);
  return cudaGetLastError();
}

}  // extern "C"
