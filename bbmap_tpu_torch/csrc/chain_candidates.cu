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
// Two mappings, one launch a call each; the wrapper picks by W.
//
// "smem" (any W up to ~1,300; the long path's W = 512): a warp a read
// (blocks of kWarps warps). Its row's keys are sorted in the warp's slice
// of shared memory by a bitonic network over the row padded to a power of
// two; then the scans as warp scans over pieces of 32 slots with a carry:
// a backward pass (next boundary, next run start), a forward pass (chain
// start, distinct flags, counts, ordinal, the running max of the packed
// run), a backward pass (the suffix max of the packed counts). The read's
// per-slot rows (diagonal, last slot, chain start, gmax, votes) stay in
// shared memory for the table: K rounds of a warp argmax over 2W composite
// keys (votes << 32 | 2W - 1 - slot), then lane k gathers entry k. 8 P +
// 44 W bytes a warp (P the padded row): 3.3 KB at W = 64, 26 KB at W = 512.
//
// "regs" (W <= 128; the short path's W = 64): a warp a read and no shared
// memory. Slot p * 32 + lane of each row lives in that lane's registers,
// NP = 1, 2 or 4 slots a lane (W 65-96 pads a fourth piece). The two rows'
// bitonic networks run interleaved, steps with j < 32 by __shfl_xor_sync,
// steps with j >= 32 inside the lane, on a 32-bit key (diag - the row's
// least) << tb | toff where the read's rows fit it (the short path's: a
// few million diagonals, 18 key slots), else on the int64 key; then diag
// and toff come back out of the key. Every scan whose
// operand is a flag becomes a __ballot_sync word a piece, read by __popc /
// __ffs / __clz with a carry over the pieces: the next boundary and run
// start, the last chain start, the chain ordinal, the distinct keys. A
// slot's key is new unless an earlier slot of its chain has it: inside a
// piece by __match_any_sync, across pieces by a bit set of the spilled
// chain's key slots (__reduce_or_sync, where they are all below 32) or a
// broadcast of that piece's keys. A chain's votes are the new keys between
// its first and last slot: the suffix max of the packed counts reads
// exactly that. gmax stays a shuffle max scan. The top K are K rounds of
// __reduce_max_sync over 32-bit keys votes << 16 | (2W - 1 - slot), each
// lane's keys ordered first so that a round reads one key a lane; lane k
// fetches entry k's slots from their lanes by __shfl_sync.
//
// What bounds it: bytes at the main path's size. diag and toff are read
// once (8 B a slot) and the (B, 8) table written once: ~78 MB at 65,536
// reads of 2 x 64 slots. The smem mapping spends ~6,200 warp instruction
// slots a read there, 0.39 ms on an H100 (the sort's shared-memory steps
// with half the lanes idle, 3 passes each recomputing the flags, a serial
// distinct-key loop, int64 shuffles); the regs mapping's sort is ~21
// shuffle steps a row with every lane busy (one shuffle and a min or max a
// slot a step on the 32-bit key) and its scans a few bit operations a
// piece.

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


// ---- the register mapping (W <= 128) --------------------------------------

constexpr int kRegWarps = 4;          // reads a block, regs mapping
constexpr unsigned kSpillBits = 32;   // key slots a spill bit set holds

// Bits of a 32-slot piece at lanes >= lo (lo <= 0: all; lo >= 32: none).
__device__ __forceinline__ unsigned lanes_from(int lo) {
  return lo <= 0 ? 0xffffffffu : (lo >= 32 ? 0u : (0xffffffffu << lo));
}

// Bits of a 32-slot piece at lanes < hi (hi <= 0: none; hi >= 32: all).
__device__ __forceinline__ unsigned lanes_below(int hi) {
  return hi <= 0 ? 0u : (hi >= 32 ? 0xffffffffu : ((1u << hi) - 1u));
}

// One sorted row's chain segmentation in registers: d, t the sorted
// diagonals and key slots of slots p * 32 + lane. Out, per slot: last (the
// chain's last slot, clamped), segs (the last chain start <= slot, -1 if
// none), gmax (the running max of the packed (ordinal, run, offset)) and
// votes (the chain's distinct keys at its first slot, else 0).
template <int NP>
__device__ __forceinline__ void chain_row_regs(
    const int (&d)[NP], const int (&t)[NP], int W, int chain_dist, int lane,
    int (&last)[NP], int (&segs)[NP], int (&gmax)[NP], int (&votes)[NP]) {
  unsigned vb[NP], ncb[NP], nrb[NP], bb[NP], rb[NP];
  bool nr[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int i = (p << 5) + lane;
    int fp = __shfl_up_sync(kFull, d[p], 1);
    if (p > 0) {
      const int carry = __shfl_sync(kFull, d[p - 1], 31);
      if (lane == 0) fp = carry;
    }
    const bool valid = i < W && d[p] < kInvalid;
    const int dd = static_cast<int>(static_cast<unsigned>(d[p]) -
                                    static_cast<unsigned>(fp));
    const bool nc = valid && (i == 0 || dd > chain_dist);
    nr[p] = valid && (i == 0 || dd != 0 || nc);
    const unsigned in = lanes_below(W - (p << 5));
    vb[p] = __ballot_sync(kFull, valid);
    ncb[p] = __ballot_sync(kFull, nc);
    nrb[p] = __ballot_sync(kFull, nr[p]);
    bb[p] = ncb[p] | (in & ~vb[p]);       // boundaries: chain starts, invalid
    rb[p] = nrb[p] | (in & ~vb[p]);       // run starts, invalid
  }
  // uniform carries: the first boundary / run start in the pieces after
  // p (W if none), the last chain start before p (-1) and the chain
  // starts before p
  int next_b[NP], next_r[NP], prev_s[NP], ord0[NP];
  {
    int nb = W, nrs = W;
#pragma unroll
    for (int p = NP - 1; p >= 0; --p) {
      next_b[p] = nb;
      next_r[p] = nrs;
      if (bb[p]) nb = (p << 5) + __ffs(bb[p]) - 1;
      if (rb[p]) nrs = (p << 5) + __ffs(rb[p]) - 1;
    }
    int ps = -1, o = 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      prev_s[p] = ps;
      ord0[p] = o;
      if (ncb[p]) ps = (p << 5) + 31 - __clz(ncb[p]);
      o += __popc(ncb[p]);
    }
  }
  const unsigned above = 0xfffffffeu << lane;   // lanes > lane
  const unsigned upto = 0xffffffffu >> (31 - lane);   // lanes <= lane
  const unsigned below = upto >> 1;             // lanes < lane
  unsigned inb[NP];
  int run[NP], ord[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int i = (p << 5) + lane;
    const unsigned ba = bb[p] & above, ra = rb[p] & above;
    const int nb = ba ? (p << 5) + __ffs(ba) - 1 : next_b[p];
    const int nrs = ra ? (p << 5) + __ffs(ra) - 1 : next_r[p];
    last[p] = min(max(nb - 1, 0), W - 1);
    run[p] = nr[p] ? nrs - i : 0;
    const unsigned su = ncb[p] & upto;
    const int s = su ? (p << 5) + 31 - __clz(su) : prev_s[p];
    segs[p] = s;
    ord[p] = ord0[p] + __popc(su);
    // a key seen before in the chain: inside the piece
    const unsigned same = __match_any_sync(kFull, t[p]);
    bool dup = (same & below & lanes_from(s - (p << 5))) != 0;
    // ... and in the pieces before it, for the chain that spills into
    // this piece (the lanes before its first chain start)
    const int sp = prev_s[p];
    if (p > 0 && sp >= 0 && (vb[p] & 1u) && !(ncb[p] & 1u)) {
      const bool spilled = s == sp;
#pragma unroll
      for (int q = 0; q < p; ++q) {
        if (q < (sp >> 5)) continue;
        const int lo = q == (sp >> 5) ? (sp & 31) : 0;
        const bool mine = lane >= lo;
        if (!__any_sync(kFull, mine && static_cast<unsigned>(t[q]) >=
                                            kSpillBits)) {
          const unsigned keys = __reduce_or_sync(
              kFull, mine ? 1u << t[q] : 0u);
          dup |= spilled && static_cast<unsigned>(t[p]) < kSpillBits &&
                 ((keys >> t[p]) & 1u);
        } else {
          for (int src = lo; src < 32; ++src) {
            const int other = __shfl_sync(kFull, t[q], src);
            dup |= spilled && other == t[p];
          }
        }
      }
    }
    inb[p] = __ballot_sync(kFull, (vb[p] >> lane & 1u) && !dup);
  }
  // votes at a chain start: the new keys in [start, last]
  int in_pref[NP + 1];
  in_pref[0] = 0;
#pragma unroll
  for (int p = 0; p < NP; ++p) in_pref[p + 1] = in_pref[p] + __popc(inb[p]);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int x = last[p] + 1;          // new keys at slots < x
    const int px = x >> 5;
    int cx = in_pref[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
      if (q == px) cx = in_pref[q] + __popc(inb[q] & lanes_below(x & 31));
    const int ci = in_pref[p] + __popc(inb[p] & below);
    votes[p] = (ncb[p] >> lane & 1u) ? cx - ci : 0;
  }
  // gmax: the running max of the packed (ordinal, run, offset in chain)
  int cg = INT_MIN;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int i = (p << 5) + lane;
    const int meta = (min(max(run[p], 0), 255) << 8) |
                     (255 - min(max(i - segs[p], 0), 255));
    const int g = max(incl_max((ord[p] << 16) | (nr[p] ? meta : 0), lane),
                      cg);
    gmax[p] = g;
    cg = __shfl_sync(kFull, g, 31);
  }
}

// The value of v at slot x of row h (a per-lane slot): shuffled from its
// lane in every (row, piece) and kept where it is the asked one.
template <int NP>
__device__ __forceinline__ int fetch(const int (&v)[2][NP], int h, int x) {
  int out = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int got = __shfl_sync(kFull, v[r][p], x & 31);
      if (r == h && p == (x >> 5)) out = got;
    }
  return out;
}

// The two rows' bitonic networks over 32 NP keys, ascending, interleaved:
// slot p * 32 + lane of row h in sk[h][p]; steps with j < 32 by
// __shfl_xor_sync, steps with j >= 32 inside the lane.
template <int NP, class Key>
__device__ __forceinline__ void bitonic(Key (&sk)[2][NP], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * NP; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int q = p ^ (j >> 5);
          if (q < p) continue;
          const bool up = ((p << 5) & k) == 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const Key lo = min(sk[h][p], sk[h][q]);
            const Key hi = max(sk[h][p], sk[h][q]);
            sk[h][p] = up ? lo : hi;
            sk[h][q] = up ? hi : lo;
          }
        }
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const bool keep_min = lower == ((((p << 5) + lane) & k) == 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const Key o = __shfl_xor_sync(kFull, sk[h][p], j);
            sk[h][p] = keep_min ? min(sk[h][p], o) : max(sk[h][p], o);
          }
        }
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(32 * kRegWarps)
chain_candidates_regs_kernel(
    const int* __restrict__ diag, const int* __restrict__ toff, int B, int W,
    int chain_dist, int K, int* __restrict__ votes, int* __restrict__ mode,
    int* __restrict__ strand, int* __restrict__ start,
    int* __restrict__ spread) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kRegWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  int d[2][NP], t[2][NP];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int i = (p << 5) + lane;
      const long long at = (b * 2 + h) * W + i;
      d[h][p] = i < W ? __ldg(diag + at) : INT_MAX;
      t[h][p] = i < W ? __ldg(toff + at) : 0;
    }
  // The rows sort on the int64 key diag * 65536 + toff. Where every
  // valid slot of both rows has 0 <= toff < 2^tb, every invalid one diag
  // 2^30 exactly and the valid diagonals a row span less than 2^(32 - tb)
  // - 1, the 32-bit key (diag - the row's least) << tb | toff, all ones
  // where invalid, orders them the same: one shuffle a step, not two.
  int lo[2], tb = 0;
  bool narrow = true;
  {
    int dmax[2], tmax = 0, tmin = 0;
    bool odd = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bool in = (p << 5) + lane < W;
        const bool valid = in && d[h][p] < kInvalid;
        odd |= in && !valid && d[h][p] != kInvalid;
        if (valid) {
          mn = min(mn, d[h][p]);
          mx = max(mx, d[h][p]);
          tmax = max(tmax, t[h][p]);
          tmin = min(tmin, t[h][p]);
        }
      }
      lo[h] = __reduce_min_sync(kFull, mn);
      dmax[h] = __reduce_max_sync(kFull, mx);
    }
    tmax = __reduce_max_sync(kFull, tmax);
    tmin = __reduce_min_sync(kFull, tmin);
    tb = 32 - __clz(tmax);
    narrow = !__any_sync(kFull, odd) && tmin >= 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      narrow = narrow && (dmax[h] < lo[h] ||
                          static_cast<long long>(dmax[h]) - lo[h] <
                              (1ll << (32 - tb)) - 1);
  }
  if (narrow) {
    unsigned sk[2][NP];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        sk[h][p] = (p << 5) + lane < W && d[h][p] < kInvalid
                       ? (static_cast<unsigned>(d[h][p]) -
                          static_cast<unsigned>(lo[h])) << tb |
                             static_cast<unsigned>(t[h][p])
                       : 0xffffffffu;
    bitonic<NP>(sk, lane);
    const unsigned tmask = (1u << tb) - 1u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bool valid = sk[h][p] != 0xffffffffu;
        d[h][p] = valid ? static_cast<int>((sk[h][p] >> tb) +
                                           static_cast<unsigned>(lo[h]))
                        : kInvalid;
        t[h][p] = valid ? static_cast<int>(sk[h][p] & tmask) : 0;
      }
  } else {
    long long sk[2][NP];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        sk[h][p] = (p << 5) + lane < W
                       ? static_cast<long long>(d[h][p]) * 65536 + t[h][p]
                       : LLONG_MAX;
    bitonic<NP>(sk, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        d[h][p] = static_cast<int>(sk[h][p] >> 16);
        t[h][p] = static_cast<int>(sk[h][p] & 0xFFFF);
      }
  }
  int last[2][NP], segs[2][NP], gmax[2][NP], vts[2][NP];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    chain_row_regs<NP>(d[h], t[h], W, chain_dist, lane, last[h], segs[h],
                       gmax[h], vts[h]);

  // top K over the read's 2W slots: votes desc, the lowest slot on ties.
  // Each lane orders its 2 NP keys (unique: they hold the slot), then each
  // round takes the warp's largest head and its lane drops it.
  constexpr int NK = 2 * NP;
  const int W2 = 2 * W;
  int key[NK];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int i = (p << 5) + lane;
      key[h * NP + p] =
          i < W ? (vts[h][p] << 16) | (W2 - 1 - (h * W + i)) : -1;
    }
#pragma unroll
  for (int r = 0; r < NK; ++r)
#pragma unroll
    for (int i = r & 1; i + 1 < NK; i += 2) {
      const int a = max(key[i], key[i + 1]), c = min(key[i], key[i + 1]);
      key[i] = a;
      key[i + 1] = c;
    }
  int mine = 0;
  for (int r = 0; r < K; ++r) {
    const int best = __reduce_max_sync(kFull, key[0]);
    const bool drop = key[0] == best;
#pragma unroll
    for (int i = 0; i + 1 < NK; ++i) key[i] = drop ? key[i + 1] : key[i];
    if (drop) key[NK - 1] = -1;
    if (lane == r) mine = best;
  }
  const int slot = W2 - 1 - (mine & 0xFFFF);
  const int my_votes = mine >> 16;
  const int half = slot >= W ? 1 : 0;
  const int x = slot - half * W;
  const int cd_start = fetch<NP>(d, half, x);
  const int cd_last = min(max(fetch<NP>(last, half, x), 0), W - 1);
  const int seg = fetch<NP>(segs, half, x);
  const int cd_stop = fetch<NP>(d, half, cd_last);
  const int win_off = 255 - (fetch<NP>(gmax, half, cd_last) & 0xFF);
  const int mi = min(max(seg + win_off, 0), W - 1);
  const int cd_mode = fetch<NP>(d, half, mi);
  if (lane < K) {
    const long long e = b * K + lane;
    votes[e] = my_votes;
    mode[e] = cd_mode;
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


// The register mapping: the same operands and outputs, W <= 128 (the
// wrapper's mapping "regs").
cudaError_t chain_candidates_regs_launch(const int* diag, const int* toff,
                                         int B, int W, int chain_dist, int K,
                                         int* votes, int* mode, int* strand,
                                         int* start, int* spread,
                                         cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (W < 1 || W > 128 || K < 1 || K > 32 || 2 * W < K)
    return cudaErrorInvalidValue;
  const int blocks = (B + kRegWarps - 1) / kRegWarps;
  const int threads = 32 * kRegWarps;
  if (W <= 32)
    chain_candidates_regs_kernel<1><<<blocks, threads, 0, stream>>>(
        diag, toff, B, W, chain_dist, K, votes, mode, strand, start, spread);
  else if (W <= 64)
    chain_candidates_regs_kernel<2><<<blocks, threads, 0, stream>>>(
        diag, toff, B, W, chain_dist, K, votes, mode, strand, start, spread);
  else
    chain_candidates_regs_kernel<4><<<blocks, threads, 0, stream>>>(
        diag, toff, B, W, chain_dist, K, votes, mode, strand, start, spread);
  return cudaGetLastError();
}

}  // extern "C"
