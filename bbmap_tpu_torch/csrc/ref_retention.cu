// Reference-faithful key retention: staged re-admission on canonical
// counts, then the Solver-weighted greedy hit-list trim, one launch a
// batch and no host synchronisation.
//
// Replaces the JAX package's _ref_retention
// (bbmap_tpu/align/quickmap_device.py:513, its greedy trim a
// jax.lax.while_loop at :688-693 inside the fused XLA program; reference:
// BBIndex.find:421-440 and Solver).
//
// The function, per read (kp its keys, -1 unused; off their offsets on the
// plus strand; ccnt their canonical counts; w the Solver weights, or none):
//
//   admission: hit_t = kp >= 0 & ccnt > 0 & ccnt < tier_t for the tiers
//     maxLen, 3 maxLen / 2, 2, 3 and 5 maxLen; n_t their counts; the sel
//     ladder escalates (tiers 1..4 needing 4, 3, 3, 2) while n_sel is below
//     the need and below trig = 3 nk / 4, once n_0 > 0; adm = hit_sel
//   the weights compacted to admitted-slot order (position r holds the
//     r-th admitted slot's weight)
//   initial = # adm, total = sum of their counts, shortest their least
//     count; a read whose shortest is past max(20, limit_shortest) keeps
//     nothing; limit = max(20, limit_avg) initial, limit2 = max(20,
//     limit_avg2), max_lists = max(trunc(0.85f * initial), 6); the first and
//     last admitted slots, the last one's offset
//   the greedy loop, while the read is active: cond = hits >= 1 and (total
//     > limit or floor(total / initial) > limit2 or hits > max_lists); each
//     alive key's value from its neighbours' offsets (prefix max of the
//     alive offsets before it, suffix min after it), its alive rank's
//     weight and its count; the worst key is the first that sets a new
//     running minimum below EARLY_TERMINATION_SCORE (not the first alive
//     key), else the argmin (lowest index on ties); total -= its count; the
//     loop stops when the worst value is > 0 or its count < 20, else the key
//     dies and hits drops by one.
//
// The eager loop runs every read until no read is active; a read's state
// changes only while its own cond holds, and cond does not depend on the
// round's scans, so a read may stop on its own round: here each read loops
// until its cond fails or it stops. int32 sums and products that can pass
// 2^31 (space, tail, vp, the value) are computed in unsigned arithmetic,
// so they wrap as the eager int32 ops do; divisions of non-negative values
// truncate as a floor does, and floor(total / initial) > limit2 is total
// >= (limit2 + 1) initial in 64 bits. The divisions no round changes
// (300000 / count) are made once, the round's (60000 / numl) once a round.
// The weight product is __int2float_rn, __fmul_rn and __float2int_rz, and
// 0.85f * initial is __fmul_rn, so nvcc contracts nothing.
//
// What bounds it: bytes at the main path's size (keys, offsets, counts and
// weights read once, 16 B a key, the flags written: ~20 MB at 65,536 x
// 18); on the long path (32 reads of 750 keys) the rounds' dependent
// scans on few SMs. Two mappings (quickmap_device.retention_mapping picks
// by nk):
//  - "regs", nk <= 32 (the main path's 18): a warp a read, a key a lane.
//    The four inputs load at once; offsets, counts, weights and the alive
//    flag stay in registers, with no shared memory and no __syncwarp. The
//    tier counts are ballots; lane r holds the r-th admitted key's weight
//    (a popcount search of the admission ballot, then a shuffle). A round
//    is one prefix max and one suffix min of the alive offsets (in one
//    loop), the alive rank as a popcount of the alive ballot below the
//    lane, one running min of the values, the first trigger by ballot and
//    the argmin as __reduce_min_sync then the lowest lane holding it.
//  - "block", nk > 32 (the long path's 750): a block a read, KPT keys a
//    thread (one up to 1,024 keys, up to 8 for 8,192). Each round's scans
//    are block scans: a thread's own keys, a warp scan, the warp totals
//    in shared memory and one pass over them after a __syncthreads; the
//    argmin and the first trigger are block reductions whose ties go to
//    the lowest warp. A round is three barriers and a few warp scans where
//    a warp a read walked 24 pieces of 32 keys in turn. The compacted
//    weights and the round's values and counts (for the worst key's) sit
//    in shared memory, 12 B a key.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // reads a block in the regs mapping
constexpr int kBig = 1 << 30;
constexpr int kEarlyTermination = -100000;   // Solver.java:232
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90
constexpr int kMaxThreads = 1024;

struct Config {
  int tier[5];
  int trig, limit3, limit_avg, limit2, pps, vm_cap, chunk;
};

// The admission tier of the sel ladder, from the tier counts n.
__device__ inline int admission_tier(const int n[5], const Config& cfg) {
  const bool gate = n[0] > 0;
  const int need[5] = {0, 4, 3, 3, 2};
  int num = n[0], tier = cfg.tier[0];
#pragma unroll
  for (int t = 1; t < 5; ++t) {
    if (gate && num < need[t] && num < cfg.trig) {
      num = n[t];
      tier = cfg.tier[t];
    }
  }
  return tier;
}

// The position of the r-th set bit of m (any lane where m has none).
__device__ inline int nth_set(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (r >= c) {
      r -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

// The part of a key's vp that no round changes: 300000 / its count, and
// 40000 more for the first and the last admitted key.
__device__ inline unsigned key_part(int l, bool first_or_last) {
  return static_cast<unsigned>(300000 / max(l, 1)) +
         (first_or_last ? 40000u : 0u);
}

// A key's value in a round: its neighbours' offsets offL (-1 if none
// before it) and next (kBig if none after it), its weight w (with
// weights), its count l, its key_part; numl = max(hits, 1) and the
// round's part of vp, 30000 + 60000 / numl.
__device__ inline int key_value(int o, int offL, int next, int l, float w,
                                bool weighted, unsigned kpart, int numl,
                                unsigned rpart, int off_last,
                                const Config& cfg) {
  const bool is_first = offL == -1;
  const bool is_last = next == kBig;
  const unsigned uo = static_cast<unsigned>(o);
  const unsigned uL = static_cast<unsigned>(offL);
  const unsigned uR = is_last ? static_cast<unsigned>(off_last) + 1u
                              : static_cast<unsigned>(next);
  const unsigned vp = rpart + kpart;
  const unsigned oldL = uo - uL, oldR = uR - uo, newS = uR - uL;
  const unsigned space = ((oldL * oldL + oldR * oldR) - newS * newS) *
                         static_cast<unsigned>(-30);
  const int gap = static_cast<int>(uR - (uL + cfg.chunk));
  const unsigned uc = is_first  ? uR - uo
                      : is_last ? uo - uL
                                : static_cast<unsigned>(max(gap, 0));
  const unsigned tail = (is_first || is_last) ? 11500u * uc : 6000u * uc;
  const int vp_final = static_cast<int>(
      numl == 1 ? vp + 11500u * static_cast<unsigned>(cfg.chunk)
                : vp + space + tail);
  int vpw = vp_final;
  if (weighted) vpw = __float2int_rz(__fmul_rn(__int2float_rn(vp_final), w));
  return static_cast<int>(static_cast<unsigned>(vpw) +
                          static_cast<unsigned>(cfg.pps) *
                              static_cast<unsigned>(min(l, cfg.vm_cap)));
}

// The read's limits once admission is known; floor(total / initial) >
// limit2 is total >= (limit2 + 1) max(initial, 1), in 64 bits.
struct Limits {
  int limit, max_lists;
  long long over2;
};

__device__ inline Limits limits_of(int initial, const Config& cfg) {
  Limits lim;
  lim.limit = static_cast<int>(static_cast<unsigned>(cfg.limit_avg) *
                               static_cast<unsigned>(initial));
  lim.max_lists = max(
      __float2int_rz(__fmul_rn(0.85f, __int2float_rn(initial))), 6);
  lim.over2 = (static_cast<long long>(cfg.limit2) + 1) * max(initial, 1);
  return lim;
}

__device__ inline bool trims(int hits, int total, const Limits& lim,
                             const Config& cfg) {
  return hits >= 1 && (total > lim.limit || total >= lim.over2 ||
                       hits > lim.max_lists);
}

__global__ void __launch_bounds__(32 * kWarps) retention_regs_kernel(
    const int* __restrict__ kp, const int* __restrict__ off_p,
    const int* __restrict__ ccnt, const float* __restrict__ weights, int B,
    int nk, Config cfg, uint8_t* __restrict__ alive_out) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (b >= B) return;                       // the whole warp
  const long long at = b * nk;
  const bool in = lane < nk;
  int key = -1, o = 0, c = 0;
  float w = 0.f;
  if (in) {
    key = kp[at + lane];
    o = off_p[at + lane];
    c = ccnt[at + lane];
    if (weights != nullptr) w = weights[at + lane];
  }
  const bool ok = key >= 0 && c > 0;
  int n[5];
#pragma unroll
  for (int t = 0; t < 5; ++t)
    n[t] = __popc(__ballot_sync(kFull, ok && c < cfg.tier[t]));
  const bool adm = ok && c < admission_tier(n, cfg);
  const unsigned ball = __ballot_sync(kFull, adm);
  const int initial = __popc(ball);
  const unsigned total0 =
      __reduce_add_sync(kFull, adm ? static_cast<unsigned>(c) : 0u);
  const int shortest = __reduce_min_sync(kFull, adm ? c : kBig);
  const int first_adm = ball ? __ffs(ball) - 1 : 0;
  const int last_adm = ball ? 31 - __clz(ball) : nk - 1;
  const int off_last = __shfl_sync(kFull, o, last_adm);
  // lane r: the r-th admitted key's weight
  const float wc = __shfl_sync(kFull, w, nth_set(ball, lane));
  const bool kill = initial >= 1 && shortest > cfg.limit3;
  const Limits lim = limits_of(initial, cfg);
  bool alive = adm && !kill;
  int hits = kill ? 0 : initial;
  int total = kill ? 0 : static_cast<int>(total0);
  const unsigned kpart = key_part(c, lane == first_adm || lane == last_adm);
  const unsigned below = (1u << lane) - 1u;
  while (trims(hits, total, lim, cfg)) {
    const int numl = max(hits, 1);
    const unsigned rpart = 30000u + static_cast<unsigned>(60000 / numl);
    const unsigned ab = __ballot_sync(kFull, alive);
    const int first_alive = ab ? __ffs(ab) - 1 : 0;
    // the alive offsets' prefix max and suffix min, then each key's
    // neighbours: the max before it and the min after it
    int pmax = alive ? o : -1, smin = alive ? o : kBig;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, pmax, d);
      const int down = __shfl_down_sync(kFull, smin, d);
      if (lane >= d) pmax = max(pmax, up);
      if (lane + d < 32) smin = min(smin, down);
    }
    int offL = __shfl_up_sync(kFull, pmax, 1);
    int next = __shfl_down_sync(kFull, smin, 1);
    if (lane == 0) offL = -1;
    if (lane == 31) next = kBig;
    const float wk = __shfl_sync(kFull, wc, __popc(ab & below));
    int val = in ? kBig : INT_MAX;
    if (alive)
      val = key_value(o, offL, next, c, wk, weights != nullptr, kpart, numl,
                      rpart, off_last, cfg);
    // the running min before each key, the first trigger, the argmin
    int rmin = val;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, rmin, d);
      if (lane >= d) rmin = min(rmin, up);
    }
    int before = __shfl_up_sync(kFull, rmin, 1);
    if (lane == 0) before = kBig;
    before = min(before, kBig);
    const unsigned tb = __ballot_sync(
        kFull, alive && val < before && before < kEarlyTermination &&
                   lane != first_alive);
    const int vmin = __reduce_min_sync(kFull, val);
    const unsigned mb = __ballot_sync(kFull, val == vmin);
    const int worst = tb ? __ffs(tb) - 1 : __ffs(mb) - 1;
    const int worst_value = __shfl_sync(kFull, val, worst);
    const int worst_len = __shfl_sync(kFull, alive ? c : 0, worst);
    total = static_cast<int>(static_cast<unsigned>(total) -
                             static_cast<unsigned>(worst_len));
    if (worst_value > 0 || worst_len < 20) break;
    if (lane == worst) alive = false;
    hits -= 1;
  }
  if (in) alive_out[at + lane] = alive;
}

// Warp scans of int: inclusive prefix max / sum (up) and suffix min (down).
__device__ inline int warp_prefix_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__device__ inline int warp_prefix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = min(v, o);
  }
  return v;
}

__device__ inline int warp_prefix_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__device__ inline int warp_suffix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  return v;
}

// Shared memory of the block mapping: the warp totals of each step (one
// array a step, so a step's writes never meet the step before's reads)
// and, after them, the read's compacted weights, values and counts.
struct BlockTotals {
  int tier[5][32];
  int adm_count[32], adm_first[32], adm_last[32], adm_min[32];
  unsigned adm_sum[32];
  int off_last;
  int a_count[32], a_max[32], a_min[32], a_first[32];
  int b_min[32], b_idx[32];
  int c_trig[32];
};

template <int KPT>
__global__ void __launch_bounds__(kMaxThreads) retention_block_kernel(
    const int* __restrict__ kp, const int* __restrict__ off_p,
    const int* __restrict__ ccnt, const float* __restrict__ weights, int B,
    int nk, Config cfg, uint8_t* __restrict__ alive_out) {
  __shared__ BlockTotals tot;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wc = reinterpret_cast<float*>(smem);
  int* vals = reinterpret_cast<int*>(wc + nk);
  int* lens = vals + nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long at = static_cast<long long>(blockIdx.x) * nk;
  const int j0 = tid * KPT;
  const bool weighted = weights != nullptr;

  int o[KPT], c[KPT];
  float w[KPT];
  bool in[KPT], ok[KPT], alive[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int j = j0 + i;
    in[i] = j < nk;
    const int key = in[i] ? kp[at + j] : -1;
    o[i] = in[i] ? off_p[at + j] : 0;
    c[i] = in[i] ? ccnt[at + j] : 0;
    w[i] = in[i] && weighted ? weights[at + j] : 0.f;
    ok[i] = key >= 0 && c[i] > 0;
  }
  // the tier counts
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    int m = 0;
#pragma unroll
    for (int i = 0; i < KPT; ++i) m += ok[i] && c[i] < cfg.tier[t];
    m = __reduce_add_sync(kFull, m);
    if (lane == 0) tot.tier[t][warp] = m;
  }
  __syncthreads();
  int n[5];
#pragma unroll
  for (int t = 0; t < 5; ++t)
    n[t] = __reduce_add_sync(kFull, lane < nwarps ? tot.tier[t][lane] : 0);
  const int tier = admission_tier(n, cfg);
  // admission: each key's admitted rank, initial, total0, shortest, the
  // first and last admitted keys
  int cnt = 0, mine_min = kBig, mine_first = kBig, mine_last = -1;
  unsigned mine_sum = 0;
  bool adm[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    adm[i] = ok[i] && c[i] < tier;
    if (adm[i]) {
      ++cnt;
      mine_sum += static_cast<unsigned>(c[i]);
      mine_min = min(mine_min, c[i]);
      mine_first = min(mine_first, j0 + i);
      mine_last = j0 + i;
    }
  }
  const int incl = warp_prefix_sum(cnt, lane);
  if (lane == 31) tot.adm_count[warp] = incl;
  const unsigned wsum = __reduce_add_sync(kFull, mine_sum);
  const int wmin = __reduce_min_sync(kFull, mine_min);
  const int wfirst = __reduce_min_sync(kFull, mine_first);
  const int wlast = __reduce_max_sync(kFull, mine_last);
  if (lane == 0) {
    tot.adm_sum[warp] = wsum;
    tot.adm_min[warp] = wmin;
    tot.adm_first[warp] = wfirst;
    tot.adm_last[warp] = wlast;
  }
  __syncthreads();
  const bool lw = lane < nwarps;
  const int initial = __reduce_add_sync(kFull, lw ? tot.adm_count[lane] : 0);
  const int base = __reduce_add_sync(kFull,
                                     lane < warp ? tot.adm_count[lane] : 0);
  const unsigned total0 = __reduce_add_sync(kFull, lw ? tot.adm_sum[lane]
                                                      : 0u);
  const int shortest = __reduce_min_sync(kFull, lw ? tot.adm_min[lane] : kBig);
  int first_adm = __reduce_min_sync(kFull, lw ? tot.adm_first[lane] : kBig);
  int last_adm = __reduce_max_sync(kFull, lw ? tot.adm_last[lane] : -1);
  if (first_adm == kBig) first_adm = 0;
  if (last_adm < 0) last_adm = nk - 1;
  {
    int r = base + incl - cnt;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      if (adm[i] && weighted) wc[r] = w[i];
      r += adm[i];
      if (j0 + i == last_adm) tot.off_last = o[i];
    }
  }
  __syncthreads();
  const int off_last = tot.off_last;
  const bool kill = initial >= 1 && shortest > cfg.limit3;
  const Limits lim = limits_of(initial, cfg);
  unsigned kpart[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    alive[i] = adm[i] && !kill;
    kpart[i] = key_part(c[i], j0 + i == first_adm || j0 + i == last_adm);
  }
  int hits = kill ? 0 : initial;
  int total = kill ? 0 : static_cast<int>(total0);

  while (trims(hits, total, lim, cfg)) {
    const int numl = max(hits, 1);
    const unsigned rpart = 30000u + static_cast<unsigned>(60000 / numl);
    // A: alive counts, the alive offsets' max and min, the first alive key
    int ca = 0, lmax = -1, lmin = kBig, lfirst = kBig;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      if (alive[i]) {
        ++ca;
        lmax = max(lmax, o[i]);
        lmin = min(lmin, o[i]);
        lfirst = min(lfirst, j0 + i);
      }
    }
    const int s_cnt = warp_prefix_sum(ca, lane);
    const int s_max = warp_prefix_max(lmax, lane);
    const int s_min = warp_suffix_min(lmin, lane);
    const int w_first = __reduce_min_sync(kFull, lfirst);
    if (lane == 31) {
      tot.a_count[warp] = s_cnt;
      tot.a_max[warp] = s_max;
    }
    if (lane == 0) {
      tot.a_min[warp] = s_min;
      tot.a_first[warp] = w_first;
    }
    __syncthreads();
    const int carry_cnt = __reduce_add_sync(
        kFull, lane < warp ? tot.a_count[lane] : 0);
    const int carry_max = __reduce_max_sync(
        kFull, lane < warp ? tot.a_max[lane] : -1);
    const int carry_min = __reduce_min_sync(
        kFull, lane > warp && lane < nwarps ? tot.a_min[lane] : kBig);
    int first_alive = __reduce_min_sync(kFull, lw ? tot.a_first[lane] : kBig);
    if (first_alive == kBig) first_alive = 0;
    // this thread's neighbours from the lanes before and after it
    int up_max = __shfl_up_sync(kFull, s_max, 1);
    int down_min = __shfl_down_sync(kFull, s_min, 1);
    int up_cnt = __shfl_up_sync(kFull, s_cnt, 1);
    if (lane == 0) {
      up_max = -1;
      up_cnt = 0;
    }
    if (lane == 31) down_min = kBig;
    int rank = carry_cnt + up_cnt;
    int offL = max(carry_max, up_max);
    int val[KPT];
    int nexts[KPT];
    {
      int next = min(carry_min, down_min);
#pragma unroll
      for (int i = KPT - 1; i >= 0; --i) {
        nexts[i] = next;
        if (alive[i]) next = min(next, o[i]);
      }
    }
    int lrmin = INT_MAX;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = j0 + i;
      val[i] = in[i] ? kBig : INT_MAX;
      if (alive[i]) {
        const float wk = weighted ? wc[rank] : 0.f;
        val[i] = key_value(o[i], offL, nexts[i], c[i], wk, weighted, kpart[i],
                           numl, rpart, off_last, cfg);
        offL = max(offL, o[i]);
        ++rank;
      }
      if (in[i]) {
        vals[j] = val[i];
        lens[j] = alive[i] ? c[i] : 0;
      }
      lrmin = min(lrmin, val[i]);
    }
    // B: the running min of the values, the argmin (lowest key on ties)
    const int s_rmin = warp_prefix_min(lrmin, lane);
    const int wv = __reduce_min_sync(kFull, lrmin);
    {
      const unsigned holds = __ballot_sync(kFull, lrmin == wv);
      int li = INT_MAX;
#pragma unroll
      for (int i = KPT - 1; i >= 0; --i)
        if (val[i] == wv) li = j0 + i;
      const int widx = __shfl_sync(kFull, li, __ffs(holds) - 1);
      if (lane == 0) {
        tot.b_min[warp] = wv;
        tot.b_idx[warp] = widx;
      }
    }
    __syncthreads();
    const int carry_rmin = __reduce_min_sync(
        kFull, lane < warp ? tot.b_min[lane] : INT_MAX);
    const int vmin = __reduce_min_sync(kFull, lw ? tot.b_min[lane] : INT_MAX);
    const unsigned vw = __ballot_sync(kFull, lw && tot.b_min[lane] == vmin);
    const int argmin = tot.b_idx[__ffs(vw) - 1];
    // C: the first key that sets a new running min below the early
    // termination score (not the first alive key)
    int before = __shfl_up_sync(kFull, s_rmin, 1);
    if (lane == 0) before = INT_MAX;
    before = min(min(before, carry_rmin), kBig);
    int ltrig = kBig;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = j0 + i;
      if (ltrig == kBig && alive[i] && val[i] < before &&
          before < kEarlyTermination && j != first_alive)
        ltrig = j;
      before = min(before, val[i]);
    }
    const int wtrig = __reduce_min_sync(kFull, ltrig);
    if (lane == 0) tot.c_trig[warp] = wtrig;
    __syncthreads();
    const int first_trig = __reduce_min_sync(
        kFull, lw ? tot.c_trig[lane] : kBig);
    const int worst = first_trig != kBig ? first_trig : argmin;
    const int worst_value = vals[worst];
    const int worst_len = lens[worst];
    total = static_cast<int>(static_cast<unsigned>(total) -
                             static_cast<unsigned>(worst_len));
    if (worst_value > 0 || worst_len < 20) break;
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      if (j0 + i == worst) alive[i] = false;
    hits -= 1;
  }
#pragma unroll
  for (int i = 0; i < KPT; ++i)
    if (in[i]) alive_out[at + j0 + i] = alive[i];
}

// Keys a thread of the block mapping: the fewest of 1, 2, 4 and 8 that
// keep the block within kMaxThreads threads (0: past 8,192 keys).
int keys_a_thread(int nk) {
  for (int kpt = 1; kpt <= 8; kpt <<= 1)
    if (nk <= kpt * kMaxThreads) return kpt;
  return 0;
}

template <int KPT>
cudaError_t block_launch(const int* kp, const int* off_p, const int* ccnt,
                         const float* weights, int B, int nk,
                         const Config& cfg, uint8_t* alive,
                         cudaStream_t stream) {
  const int threads = ((nk + KPT - 1) / KPT + 31) / 32 * 32;
  const size_t smem = 12 * static_cast<size_t>(nk);
  if (smem + sizeof(BlockTotals) > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kSmemDefault - sizeof(BlockTotals)) {
    const cudaError_t e = cudaFuncSetAttribute(
        retention_block_kernel<KPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  retention_block_kernel<KPT><<<B, threads, smem, stream>>>(
      kp, off_p, ccnt, weights, B, nk, cfg, alive);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B reads: kp, off_p, ccnt (B, nk) int32, weights (B, nk) float32 or null,
// row-major. tier (5,): the admission tiers; limit_avg = max(20,
// cfg.limit_avg), limit2 = max(20, cfg.limit_avg2), limit3 = max(20,
// cfg.limit_shortest). alive (B, nk) bool bytes. mapping 0: "regs" (nk <=
// 32); 1: "block" (nk <= 8,192). Other shapes return
// cudaErrorInvalidValue.
cudaError_t ref_retention_launch(const int* kp, const int* off_p,
                                 const int* ccnt, const float* weights, int B,
                                 int nk, const int* tier, int trig, int limit3,
                                 int limit_avg, int limit2, int pps,
                                 int vm_cap, int chunk, int mapping,
                                 uint8_t* alive, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (nk < 1 || (mapping != 0 && mapping != 1) || (mapping == 0 && nk > 32))
    return cudaErrorInvalidValue;
  Config cfg;
  for (int t = 0; t < 5; ++t) cfg.tier[t] = tier[t];
  cfg.trig = trig;
  cfg.limit3 = limit3;
  cfg.limit_avg = limit_avg;
  cfg.limit2 = limit2;
  cfg.pps = pps;
  cfg.vm_cap = vm_cap;
  cfg.chunk = chunk;
  if (mapping == 0) {
    const int blocks = (B + kWarps - 1) / kWarps;
    retention_regs_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
        kp, off_p, ccnt, weights, B, nk, cfg, alive);
    return cudaGetLastError();
  }
  switch (keys_a_thread(nk)) {
    case 1: return block_launch<1>(kp, off_p, ccnt, weights, B, nk, cfg,
                                   alive, stream);
    case 2: return block_launch<2>(kp, off_p, ccnt, weights, B, nk, cfg,
                                   alive, stream);
    case 4: return block_launch<4>(kp, off_p, ccnt, weights, B, nk, cfg,
                                   alive, stream);
    case 8: return block_launch<8>(kp, off_p, ccnt, weights, B, nk, cfg,
                                   alive, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
