// The candidate stage's chain step: each (read, strand) row of slot
// diagonals sorted, cut into chains, each chain's distinct-key votes and
// modal run, and the read's top-K candidate table, one launch a batch and
// no host synchronisation.
//
// Replaces the JAX package's sort, chain segmentation, votes, modal run and
// top_k inside candidate_stage (bbmap_tpu/align/quickmap_device.py:1150-1288:
// a lax.sort, 5 cummax, 2 cummin and 3 cumsum, a doubling prefix-OR over
// ceil(nk / 32) mask words, lax.top_k and one-hot row gathers, in the fused
// XLA program). The port ran it as eager tensor steps
// (_chain_candidates_plain: _sort_rows, _chain_segments, _candidate_table):
// an int64 sort, the ten scans, the prefix-OR's log2(W) steps a mask word
// (~1,000 launches a call at W = 512, nk = 750), a stable sort of the
// votes and seven gathers.
//
// The function, per read (two rows of W slots: diag, 2^30 past the row's
// valid slots, and the key slot toff):
//
//   each row sorted by the int64 key diag * 65536 + toff; f the sorted
//     diagonals, t their key slots, valid_i iff f_i < 2^30
//   new_chain_i = valid_i and (i == 0 or f_i - f_{i-1} > chain_dist);
//     new_run_i = valid_i and (i == 0 or f_i != f_{i-1} or new_chain_i)
//   last_i = clamp(next boundary after i - 1, 0, W - 1), a boundary a
//     chain start or an invalid slot (W past the row); run_i = the next
//     run start or invalid slot after i, minus i, on a run start
//   seg_start_i = the last chain start <= i (-1 if none); is_new_i iff
//     valid_i and no slot of [max(seg_start_i, 0), i) has key slot t_i (a
//     direct compare within the chain: the JAX package's prefix-OR of
//     ceil(nk / 32) mask words gives the same set)
//   dcnt_i = #is_new in [0, i] - the count before the last chain start;
//     ord_i = #new_chain in [0, i]; size_i = the low 16 bits of the suffix
//     max of ((W + 1 - ord) << 16 | (valid ? dcnt : 0)), on chain starts
//   glob_i = ord_i << 16 | (new_run_i ? min(run_i, 255) << 8 | (255 -
//     clamp(i - seg_start_i, 0, 255)) : 0); gmax_i its running max
//   the read's 2W slots (strand 0 first): the K largest size, ties to the
//     lowest slot (the stable sort's order); for each, strand = slot >= W,
//     start = f at the slot, stop = f at its chain's last slot, mode = f at
//     clamp(seg_start + 255 - (gmax at the last slot & 0xFF), 0, W - 1) of
//     its strand, spread = stop - start where votes > 0, else 0
//
// The modal run is read back through the packed words exactly as the
// plain version reads it, so a run that starts past offset 255 of its
// chain clamps to the same slot.
//
// Design: a warp a read (blocks of kWarps warps). Its row's keys are
// sorted in the warp's slice of shared memory by a bitonic network over
// the row padded to a power of two; then the scans as warp scans over
// pieces of 32 slots with a carry: a backward pass (next boundary, next
// run start), a forward pass (chain start, distinct flags, counts, ordinal,
// the running max of the packed run), a backward pass (the suffix max of
// the packed counts). The read's per-slot rows (diagonal, last slot, chain
// start, gmax, votes) stay in shared memory for the table: K rounds of a
// warp argmax over 2W composite keys (votes << 32 | 2W - 1 - slot), then
// lane k gathers entry k. 8 P + 44 W bytes a warp (P the padded row):
// 3.3 KB at W = 64, 26 KB at W = 512.
//
// What bounds it: bytes at the main path's size. diag and toff are read
// once (8 B a slot) and the (B, 8) table written once: ~69 MB at 65,536
// reads of 2 x 64 slots. The sort's W log2(W)^2 / 4 compare-exchanges a row
// and the scans run in shared memory; the distinct-key compare costs up to
// a chain's length a slot.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // reads a block
constexpr int kInvalid = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90

__host__ __device__ inline int padded(int W) {
  int P = 1;
  while (P < W) P <<= 1;
  return P;
}

__host__ __device__ inline size_t warp_bytes(int W) {
  // the row's sort keys (8 B a padded slot), its key slots (4 B a slot),
  // and the read's diagonals, last slots, chain starts, gmax and votes
  // (4 B each a slot of 2W); 16 B aligned
  const size_t b = 8 * static_cast<size_t>(padded(W)) +
                   4 * static_cast<size_t>(W) + 40 * static_cast<size_t>(W);
  return (b + 15) & ~static_cast<size_t>(15);
}

__device__ inline int incl_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__device__ inline int incl_sum(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Inclusive suffix min / max over the lanes at and after this one.
__device__ inline int suffix_min(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  return v;
}

__device__ inline int suffix_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = max(v, o);
  }
  return v;
}

// valid, new chain and new run of sorted slot i (i < W).
__device__ inline void slot_flags(const int* f, int i, int chain_dist,
                                  bool& valid, bool& nc, bool& nr) {
  const int fi = f[i];
  valid = fi < kInvalid;
  if (i == 0) {
    nc = nr = valid;
    return;
  }
  const int dd = static_cast<int>(static_cast<unsigned>(fi) -
                                  static_cast<unsigned>(f[i - 1]));
  nc = valid && dd > chain_dist;
  nr = valid && (dd != 0 || nc);
}

// The chain segmentation of one sorted row: f, t (W slots); out last,
// segs, gmax, size (W slots). size holds the run lengths, then the packed
// counts, between the passes.
__device__ void chain_row(const int* f, const int* t, int W, int chain_dist,
                          int* last, int* segs, int* gmax, int* size,
                          int lane) {
  const int npieces = (W + 31) >> 5;
  // backward: the next boundary and the next run start after each slot
  int cn = W, cr = W;
  for (int p = npieces - 1; p >= 0; --p) {
    const int i = (p << 5) + lane;
    const bool in = i < W;
    bool valid = false, nc = false, nr = false;
    if (in) slot_flags(f, i, chain_dist, valid, nc, nr);
    const int sn = min(suffix_min(in && (nc || !valid) ? i : W, lane), cn);
    const int sr = min(suffix_min(in && (nr || !valid) ? i : W, lane), cr);
    int en = __shfl_down_sync(kFull, sn, 1);
    int er = __shfl_down_sync(kFull, sr, 1);
    if (lane == 31) {
      en = cn;
      er = cr;
    }
    cn = __shfl_sync(kFull, sn, 0);
    cr = __shfl_sync(kFull, sr, 0);
    if (in) {
      last[i] = min(max(en - 1, 0), W - 1);
      size[i] = nr ? er - i : 0;
    }
  }
  __syncwarp();
  // forward: chain start, distinct flag, counts, ordinal, packed run max
  int cs = -1, cc = 0, cb = -1, co = 0, cg = INT_MIN;
  for (int p = 0; p < npieces; ++p) {
    const int i = (p << 5) + lane;
    const bool in = i < W;
    bool valid = false, nc = false, nr = false;
    if (in) slot_flags(f, i, chain_dist, valid, nc, nr);
    const int s = max(incl_max(in && nc ? i : -1, lane), cs);
    int is_new = 0;
    if (in && valid) {
      const int ti = t[i];
      is_new = 1;
      for (int j = max(s, 0); j < i; ++j) {
        if (t[j] == ti) {
          is_new = 0;
          break;
        }
      }
    }
    const int c = incl_sum(is_new, lane) + cc;
    const int base = max(incl_max(in && nc ? c - is_new : -1, lane), cb);
    const int dcnt = c - max(base, 0);
    const int ord = incl_sum(in && nc ? 1 : 0, lane) + co;
    const int run = in ? size[i] : 0;
    const int meta = (min(max(run, 0), 255) << 8) |
                     (255 - min(max(i - s, 0), 255));
    const int glob = (ord << 16) | (nr ? meta : 0);
    const int g = max(incl_max(glob, lane), cg);
    if (in) {
      segs[i] = s;
      gmax[i] = g;
      size[i] = ((W + 1 - ord) << 16) | (valid ? dcnt : 0);
    }
    cs = __shfl_sync(kFull, s, 31);
    cc = __shfl_sync(kFull, c, 31);
    cb = __shfl_sync(kFull, base, 31);
    co = __shfl_sync(kFull, ord, 31);
    cg = __shfl_sync(kFull, g, 31);
  }
  __syncwarp();
  // backward: each chain's distinct count at its first slot
  int cm = INT_MIN;
  for (int p = npieces - 1; p >= 0; --p) {
    const int i = (p << 5) + lane;
    const bool in = i < W;
    bool valid = false, nc = false, nr = false;
    if (in) slot_flags(f, i, chain_dist, valid, nc, nr);
    const int m = max(suffix_max(in ? size[i] : INT_MIN, lane), cm);
    cm = __shfl_sync(kFull, m, 0);
    if (in) size[i] = nc ? (m & 0xFFFF) : 0;
  }
  __syncwarp();
}

__global__ void chain_candidates_kernel(
    const int* __restrict__ diag, const int* __restrict__ toff, int B, int W,
    int chain_dist, int K, int* __restrict__ votes, int* __restrict__ mode,
    int* __restrict__ strand, int* __restrict__ start,
    int* __restrict__ spread) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;
  const int P = padded(W);
  const int W2 = 2 * W;
  long long* key =
      reinterpret_cast<long long*>(smem + warp * warp_bytes(W));
  int* tf = reinterpret_cast<int*>(key + P);
  int* flat = tf + W;
  int* last = flat + W2;
  int* segs = last + W2;
  int* gmax = segs + W2;
  int* size = gmax + W2;

  for (int h = 0; h < 2; ++h) {
    const long long at = (b * 2 + h) * W;
    for (int i = lane; i < P; i += 32)
      key[i] = i < W ? static_cast<long long>(diag[at + i]) * 65536 +
                           toff[at + i]
                     : LLONG_MAX;
    __syncwarp();
    // bitonic sort, ascending
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = lane; i < P; i += 32) {
          const int l = i ^ j;
          if (l > i) {
            const long long a = key[i], c = key[l];
            if ((a > c) == ((i & k) == 0)) {
              key[i] = c;
              key[l] = a;
            }
          }
        }
        __syncwarp();
      }
    }
    const int o = h * W;
    for (int i = lane; i < W; i += 32) {
      flat[o + i] = static_cast<int>(key[i] >> 16);
      tf[i] = static_cast<int>(key[i] & 0xFFFF);
    }
    __syncwarp();
    chain_row(flat + o, tf, W, chain_dist, last + o, segs + o, gmax + o,
              size + o, lane);
  }

  // top K over the read's 2W slots: votes desc, the lowest slot on ties
  long long prev = LLONG_MAX;
  int my_slot = 0, my_votes = 0;
  for (int r = 0; r < K; ++r) {
    long long best = LLONG_MIN;
    for (int i = lane; i < W2; i += 32) {
      const long long c = (static_cast<long long>(size[i]) << 32) +
                          (W2 - 1 - i);
      if (c < prev && c > best) best = c;
    }
    for (int d = 16; d >= 1; d >>= 1)
      best = max(best, __shfl_xor_sync(kFull, best, d));
    prev = best;
    if (lane == r) {
      my_slot = W2 - 1 - static_cast<int>(best & 0xffffffffLL);
      my_votes = static_cast<int>(best >> 32);
    }
  }
  if (lane < K) {
    const int half = my_slot >= W ? 1 : 0;
    const int so = half * W;
    const int cd_start = flat[my_slot];
    const int cd_last = min(max(last[my_slot] + so, 0), W2 - 1);
    const int cd_stop = flat[cd_last];
    const int win_off = 255 - (gmax[cd_last] & 0xFF);
    const int mi = min(max(segs[my_slot] + win_off, 0), W - 1);
    const long long e = b * K + lane;
    votes[e] = my_votes;
    mode[e] = flat[min(max(mi + so, 0), W2 - 1)];
    strand[e] = half;
    start[e] = cd_start;
    spread[e] = my_votes > 0
                    ? static_cast<int>(static_cast<unsigned>(cd_stop) -
                                       static_cast<unsigned>(cd_start))
                    : 0;
  }
}

}  // namespace

extern "C" {

// B reads: diag, toff (B, 2, W) int32, row-major (diag 2^30 past a row's
// valid slots). K <= 32 entries a read, 2W >= K, W < 32,768. Out: votes,
// mode, strand, start, spread (B, K) int32. Past 227 KB of shared memory a
// block (W ~ 1,300) the launch returns cudaErrorInvalidValue.
cudaError_t chain_candidates_launch(const int* diag, const int* toff, int B,
                                    int W, int chain_dist, int K, int* votes,
                                    int* mode, int* strand, int* start,
                                    int* spread, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (W < 1 || W > 32767 || K < 1 || K > 32 || 2 * W < K)
    return cudaErrorInvalidValue;
  const size_t smem = kWarps * warp_bytes(W);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  chain_candidates_kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      diag, toff, B, W, chain_dist, K, votes, mode, strand, start, spread);
  return cudaGetLastError();
}

}  // extern "C"
