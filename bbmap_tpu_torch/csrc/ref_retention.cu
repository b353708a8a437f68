// Reference-faithful key retention: staged re-admission on canonical
// counts, then the Solver-weighted greedy hit-list trim, one launch a
// batch and no host synchronisation.
//
// Replaces the JAX package's _ref_retention
// (bbmap_tpu/align/quickmap_device.py:513, its greedy trim a
// jax.lax.while_loop at :688-693 inside the fused XLA program; reference:
// BBIndex.find:421-440 and Solver). The port ran it as eager tensor steps:
// ~50 launches a round over (B, nk), with a cummax, two cummins and a
// cumsum, and a round ended in bool(active.any()), a host sync: 6 rounds
// and 7 syncs on a batch of 65,536 reads of 150 bp (nk = 18).
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
// round's scans, so a read may stop on its own round: here each warp loops
// its read until its cond fails or it stops.
//
// Design: a warp a read (blocks of kWarps warps). The read's offsets,
// counts, weights and alive flags sit in the warp's slice of shared memory;
// the round's scans are warp scans over pieces of 32 keys with a carry
// between pieces (nk is 18 at L = 150 and 750 at L = 6,000): a backward
// pass for the suffix min of the alive offsets (__shfl_down_sync), a
// forward pass for their prefix max, the alive rank, the running min of
// the values (__shfl_up_sync), the first trigger (__ballot_sync) and the
// argmin. int32 sums and products that can pass 2^31 (space, tail, vp,
// the value) are computed in unsigned arithmetic, so they wrap as the
// eager int32 ops do; divisions of non-negative values truncate as a floor
// does, and floor(total / initial) is a floor. The weight product is
// __int2float_rn, __fmul_rn and __float2int_rz, and 0.85f * initial is
// __fmul_rn, so nvcc contracts nothing.
//
// What bounds it: bytes at the main path's size (keys, offsets, counts and
// weights read once, 16 B a key, the flags written: ~20 MB at 65,536 x
// 18); on the long path (32 reads of 750 keys) the rounds' operations on
// few warps. Its gain is the launches and the syncs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // reads a block
constexpr int kBig = 1 << 30;
constexpr int kEarlyTermination = -100000;   // Solver.java:232
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90

__host__ __device__ inline size_t warp_bytes(int nk) {
  // off, cnt, the scratch row (next offsets, then values), the compacted
  // weights: 4 B each a key; the alive flags a byte a key; 16 B aligned
  return (16 * static_cast<size_t>(nk) + nk + 15) & ~static_cast<size_t>(15);
}

__device__ inline int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ inline int incl_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__device__ inline int incl_min(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = min(v, o);
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

// Inclusive suffix min over the lanes at and after this one.
__device__ inline int suffix_min(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  return v;
}

struct Config {
  int tier[5];
  int trig, limit3, limit_avg, limit2, pps, vm_cap, chunk;
};

__global__ void ref_retention_kernel(
    const int* __restrict__ kp, const int* __restrict__ off_p,
    const int* __restrict__ ccnt, const float* __restrict__ weights, int B,
    int nk, Config cfg, uint8_t* __restrict__ alive_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;
  unsigned char* mine = smem + warp * warp_bytes(nk);
  int* off = reinterpret_cast<int*>(mine);
  int* cnt = off + nk;
  int* row = cnt + nk;
  float* wc = reinterpret_cast<float*>(row + nk);
  uint8_t* alive = reinterpret_cast<uint8_t*>(wc + nk);
  const int npieces = (nk + 31) >> 5;
  const long long at = b * nk;

  // staged re-admission: the tier counts
  int n[5] = {0, 0, 0, 0, 0};
  for (int j = lane; j < nk; j += 32) {
    const int c = ccnt[at + j];
    const bool ok = kp[at + j] >= 0 && c > 0;
    off[j] = off_p[at + j];
    cnt[j] = c;
    for (int t = 0; t < 5; ++t) n[t] += ok && c < cfg.tier[t];
  }
  for (int t = 0; t < 5; ++t) n[t] = __reduce_add_sync(kFull, n[t]);
  int sel = 0;
  {
    const bool gate = n[0] > 0;
    const int need[5] = {0, 4, 3, 3, 2};
    int num = n[0];
    for (int t = 1; t < 5; ++t) {
      if (gate && num < need[t] && num < cfg.trig) {
        sel = t;
        num = n[t];
      }
    }
  }
  const int tier = cfg.tier[sel];

  // admitted slots: flags, the compacted weights, initial, total0,
  // shortest, the first and last admitted slot
  int initial = 0, first_adm = -1, last_adm = -1;
  unsigned total0 = 0;
  int shortest = kBig;
  for (int p = 0; p < npieces; ++p) {
    const int j = (p << 5) + lane;
    bool adm = false;
    if (j < nk) {
      const int c = cnt[j];
      adm = kp[at + j] >= 0 && c > 0 && c < tier;
      alive[j] = adm;
      if (adm) {
        total0 += static_cast<unsigned>(c);
        shortest = min(shortest, c);
      }
    }
    const unsigned ball = __ballot_sync(kFull, adm);
    if (weights != nullptr && adm) {
      const int r = initial + __popc(ball & ((1u << lane) - 1u));
      wc[r] = weights[at + j];
    }
    if (ball) {
      if (first_adm < 0) first_adm = (p << 5) + __ffs(ball) - 1;
      last_adm = (p << 5) + 31 - __clz(ball);
    }
    initial += __popc(ball);
  }
  total0 = __reduce_add_sync(kFull, total0);
  shortest = __reduce_min_sync(kFull, shortest);
  if (first_adm < 0) first_adm = 0;
  if (last_adm < 0) last_adm = nk - 1;
  __syncwarp();
  const int off_last = off[last_adm];
  const bool kill = initial >= 1 && shortest > cfg.limit3;
  if (kill) {
    for (int j = lane; j < nk; j += 32) alive[j] = 0;
  }
  const int limit = static_cast<int>(static_cast<unsigned>(cfg.limit_avg) *
                                     static_cast<unsigned>(initial));
  const int max_lists = max(
      __float2int_rz(__fmul_rn(0.85f, __int2float_rn(initial))), 6);
  const int initial1 = max(initial, 1);
  int hits = kill ? 0 : initial;
  int total = kill ? 0 : static_cast<int>(total0);
  bool active = !kill && initial >= 1;
  __syncwarp();

  while (active) {
    const bool over = total > limit ||
                      floor_div(total, initial1) > cfg.limit2 ||
                      hits > max_lists;
    const bool cond = hits >= 1 && over;
    if (!cond) break;
    const int numl = max(hits, 1);
    // backward: the least alive offset after each key (kBig if none), and
    // the first alive key
    int carry = kBig, first_alive = 0;
    for (int p = npieces - 1; p >= 0; --p) {
      const int j = (p << 5) + lane;
      const bool al = j < nk && alive[j];
      const int incl = suffix_min(al ? off[j] : kBig, lane);
      int excl = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) excl = kBig;
      if (j < nk) row[j] = min(excl, carry);
      carry = min(carry, __shfl_sync(kFull, incl, 0));
      const unsigned ball = __ballot_sync(kFull, al);
      if (ball) first_alive = (p << 5) + __ffs(ball) - 1;
    }
    __syncwarp();
    // forward: neighbours, values, the running min, the first trigger and
    // the argmin
    int cmax = -1, crank = 0, cmin = kBig, first_trig = -1;
    int best_val = INT_MAX, best_idx = INT_MAX;
    for (int p = 0; p < npieces; ++p) {
      const int j = (p << 5) + lane;
      const bool in = j < nk;
      const bool al = in && alive[j];
      const int o = in ? off[j] : 0;
      const int imax = incl_max(al ? o : -1, lane);
      int offL = __shfl_up_sync(kFull, imax, 1);
      if (lane == 0) offL = -1;
      offL = max(offL, cmax);
      cmax = max(cmax, __shfl_sync(kFull, imax, 31));
      const int isum = incl_sum(al ? 1 : 0, lane);
      const int rank = crank + isum - 1;
      crank += __shfl_sync(kFull, isum, 31);
      int val = kBig;
      if (al) {
        const int next = row[j];
        const bool is_first = offL == -1;
        const bool is_last = next == kBig;
        const unsigned uo = static_cast<unsigned>(o);
        const unsigned uL = static_cast<unsigned>(offL);
        const unsigned uR = is_last ? static_cast<unsigned>(off_last) + 1u
                                    : static_cast<unsigned>(next);
        const int l = cnt[j];
        unsigned vp = 30000u + static_cast<unsigned>(60000 / numl) +
                      static_cast<unsigned>(300000 / max(l, 1));
        if (j == first_adm || j == last_adm) vp += 40000u;
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
        if (weights != nullptr) {
          const float w = wc[min(max(rank, 0), nk - 1)];
          vpw = __float2int_rz(__fmul_rn(__int2float_rn(vp_final), w));
        }
        val = static_cast<int>(static_cast<unsigned>(vpw) +
                               static_cast<unsigned>(cfg.pps) *
                                   static_cast<unsigned>(min(l, cfg.vm_cap)));
      }
      const int imin = incl_min(in ? val : INT_MAX, lane);
      int before = __shfl_up_sync(kFull, imin, 1);
      if (lane == 0) before = kBig;
      before = min(before, cmin);
      cmin = min(cmin, __shfl_sync(kFull, imin, 31));
      const bool trigm = al && val < before && before < kEarlyTermination &&
                         j != first_alive;
      const unsigned tb = __ballot_sync(kFull, trigm);
      if (first_trig < 0 && tb) first_trig = (p << 5) + __ffs(tb) - 1;
      // argmin, the lowest index on ties
      int bv = in ? val : INT_MAX, bi = in ? j : INT_MAX;
      for (int d = 16; d >= 1; d >>= 1) {
        const int ov = __shfl_xor_sync(kFull, bv, d);
        const int oi = __shfl_xor_sync(kFull, bi, d);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bv < best_val || (bv == best_val && bi < best_idx)) {
        best_val = bv;
        best_idx = bi;
      }
      if (in) row[j] = val;      // this lane read row[j] above
    }
    __syncwarp();
    const int worst = first_trig >= 0 ? first_trig : best_idx;
    const int worst_value = row[worst];
    const int worst_len = alive[worst] ? cnt[worst] : 0;
    total = static_cast<int>(static_cast<unsigned>(total) -
                             static_cast<unsigned>(worst_len));
    if (worst_value > 0 || worst_len < 20) break;
    __syncwarp();
    if (lane == 0) alive[worst] = 0;
    __syncwarp();
    hits -= 1;
  }
  for (int j = lane; j < nk; j += 32) alive_out[at + j] = alive[j];
}

}  // namespace

extern "C" {

// B reads: kp, off_p, ccnt (B, nk) int32, weights (B, nk) float32 or null,
// row-major. tier (5,): the admission tiers; limit_avg = max(20,
// cfg.limit_avg), limit2 = max(20, cfg.limit_avg2), limit3 = max(20,
// cfg.limit_shortest). alive (B, nk) bool bytes. Past 227 KB of shared
// memory a block (nk ~ 3,400) the launch returns cudaErrorInvalidValue.
cudaError_t ref_retention_launch(const int* kp, const int* off_p,
                                 const int* ccnt, const float* weights, int B,
                                 int nk, const int* tier, int trig, int limit3,
                                 int limit_avg, int limit2, int pps,
                                 int vm_cap, int chunk, uint8_t* alive,
                                 cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (nk < 1) return cudaErrorInvalidValue;
  const size_t smem = kWarps * warp_bytes(nk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ref_retention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  Config cfg;
  for (int t = 0; t < 5; ++t) cfg.tier[t] = tier[t];
  cfg.trig = trig;
  cfg.limit3 = limit3;
  cfg.limit_avg = limit_avg;
  cfg.limit2 = limit2;
  cfg.pps = pps;
  cfg.vm_cap = vm_cap;
  cfg.chunk = chunk;
  const int blocks = (B + kWarps - 1) / kWarps;
  ref_retention_kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      kp, off_p, ccnt, weights, B, nk, cfg, alive);
  return cudaGetLastError();
}

}  // extern "C"
