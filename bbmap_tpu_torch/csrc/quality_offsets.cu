// Quality-driven key offsets: keyProbs, the makeOffsets3 ladder, the Solver
// weights and the probAllErrors reject flag, one launch a batch.
//
// Replaces the JAX package's _quality_offsets_core
// (bbmap_tpu/align/quickmap_device.py:781, its key ladder a `for i in
// range(nk)` loop that jit unrolls into one XLA program, :840; reference:
// QualityTools.makeKeyProbs + KeyRing.makeOffsets3, AbstractMapThread
// .java:704-727). The port ran it as eager tensor steps: two k-step loops, ~30
// launches a ladder step over (B, m) masks and an nk-step product, 1,188
// dispatches a call at L = 150 (nk = 18) and 43,640 at L = 6,000 (nk = 750).
//
// The function, per read (q phred 0..127, pc its probability correct, L bases,
// k the key length, m = L - k + 1 key positions, nk keys), all float32 and
// rounded step by step as the JAX package's operations are:
//
//   probs[i] = 1 - pc[i] * pc[i+1] * ... * pc[i+k-1] (left to right), or
//     1 where a q of the window is 0
//   ok1 = probs < 0.94, ok2 = probs < 0.9999; left / right = the first /
//     last ok1 (0 / m-1 when none); potential = # ok2 in [left, right];
//     valid = any ok1, potential > 0, right >= left
//   desired, interval: from the usable span through two host tables,
//     d2_tab (ceil in float64) and div_tab (true float32 division), so
//     the kernel divides nothing
//   the ladder, i = 0 .. nk-1, active while i < desired: x = j where
//     probs[j] < 0.9999, else the last ok2 in (prev+2, j-1], else the first
//     ok2 in [j+1, min(j+interval_int, right)), else -1; x = -1 unless
//     prev < j; prev, f += interval and j = min(max(j+1, floor(f + 0.5)),
//     m-1) advance
//   offsets: the ladder's, or the fixed ladder (cfg.offsets_list) where
//     the read is not valid
//   weights: (base_ks + floor(rng * (1 - psel) + 0.5)) * (1/a) at the
//     chosen offsets (psel 1 at an unused one); reject = valid and the
//     ordered product of psel over the used offsets > 0.5.
//
// Design: a warp a read, up to 8 reads a block (one where the batch is small:
// the long path's 32 reads spread over 32 SMs), no __syncthreads. The warp
// stages its read in its slice of shared memory, its loads in flight together:
// pc (from q and pc, 16 chunks of 32 bases at once, or on the packed route
// from the palette-packed words, a word of 8 bases a lane for 4 blocks of 256
// bases at once: a lane a base takes its word by __shfl_sync, its nibble, and
// its probability by __shfl_sync from the palette lanes) and the q == 0 flags
// as __ballot_sync words (a key window's test is one funnel shift of two
// words, so k <= 32: a loop over the words for any k took 10 to 14 percent
// longer at both shapes on an H100). The lanes then compute the window
// products, 5 chunks of 32 key positions at a time with their product chains
// interleaved, writing probs over pc in place (a group reads only from itself
// and the next one), the ok2 words by __ballot_sync and left / right from the
// ok1 ballots; potential is a __reduce_add_sync of the lanes' masked __popc.
// The ladder's searches become lookups: with the highest ok2 index at or below
// each word (a prefix max over the words) and the lowest at or above it (a
// suffix min), the backward candidate of step i is the highest ok2 index at or
// below j_i - 1 where it is >= prev + 3, and the forward one the lowest at or
// above j_i + 1 where it is below lim. The positions j_i do not depend on the
// chosen offsets: past the float additions, which run in order, they are a
// prefix max over the lanes (lane l holds step l of 32); every lane then finds
// its step's candidates at once (up to m = 1,024 the words and their tables
// stay in the lanes' registers, read by __shfl_sync, 4 percent faster on the
// packed entry at 65,536 x 150 on an H100 than the shared-memory tables, which
// hold past it), and only the prev chain (a compare and a select a step, its
// operands broadcast by __shfl_sync) runs in order. The weights are computed a
// lane an offset; the reject product stays the ordered chain of __fmul_rn over
// the lanes' psel, 32 factors a round broadcast by __shfl_sync (from 1: a
// factor of 1, past nk and before psel_0, is exact). Every product and sum is
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts none of them into an
// FMA (the JAX package's operations round each one), and the thresholds and
// constants come from the host as the float32 values the plain version uses.
//
// The packed route (quality_offsets_packed_launch) reads the fused program's
// words (8 nibbles a uint32, held in int64) with their 16-entry palette and
// probability table, where the plain route first unpacks them into (B, L) q
// and pc tensors with ~20 torch launches.
//
// What bounds it: bytes at the main path's size (65,536 reads of 150: q and pc
// read once, 8 B a base, or the packed words, 0.5 B a base of nibbles, read
// here as int64 words at 1 B a base, and the outputs). A block a read with the
// ladder on one thread (the earlier design, 0.2611 ms there on an H100) held
// 16 reads an SM, each a dependent chain of shared-memory word loops; a warp a
// read holds 64. Latency on the long path (32 reads: a warp each, 188 chunks
// and an nk = 750-step ladder): the staged loads, the interleaved window
// chains and a ladder whose sequential part is the prev chain alone.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;          // reads a block
constexpr int kSmallM = 1024;         // key positions whose ok2 words fit
                                      // one a lane
constexpr int kChunks = 5;            // window chunks a group: 150 bp
                                      // reads have 138 key positions
constexpr int kStage = 16;            // chunks of 32 bases a lane loads at
                                      // once (q and pc)
constexpr int kWords = 4;             // packed words a lane loads at once

// Bits of mask word w whose index lies in [lo, hi].
__device__ __forceinline__ unsigned bits_in(int w, int lo, int hi) {
  const int a = max(lo - (w << 5), 0);
  const int b = min(hi - (w << 5), 31);
  if (a > b) return 0u;
  const unsigned upto = b == 31 ? kFull : (1u << (b + 1)) - 1u;
  return upto & (kFull << a);
}

struct Consts {
  int L, k, nk;
  const int* d2_tab;
  const float* div_tab;
  const int* ladder;
  float l1, l2;
  int base_ks;
  float rng, inv_a;
};

// The warp's slice of shared memory: pc, then probs; the q == 0 words;
// the ok2 words with the highest / lowest set index at or below / at or
// above each word; the offsets.
struct Slice {
  float* pcs;
  unsigned* zw;
  unsigned* ok2;
  int* hw;
  int* lw;
  int* offs;
};

__host__ __device__ inline size_t warp_bytes(int L, int m, int nk) {
  const size_t nz = ((L + 31) >> 5) + 1, nw = ((m + 31) >> 5) + 1;
  const size_t b = 4 * (static_cast<size_t>(L) + nz + 3 * nw +
                        static_cast<size_t>(nk));
  return (b + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ Slice slice(unsigned char* smem, int warp, int L,
                                       int m, int nk) {
  const int nz = ((L + 31) >> 5) + 1, nw = ((m + 31) >> 5) + 1;
  Slice s;
  s.pcs = reinterpret_cast<float*>(smem + warp * warp_bytes(L, m, nk));
  s.zw = reinterpret_cast<unsigned*>(s.pcs + L);
  s.ok2 = s.zw + nz;
  s.hw = reinterpret_cast<int*>(s.ok2 + nw);
  s.lw = s.hw + nw;
  s.offs = s.lw + nw;
  return s;
}

// One read's offsets, weights and reject flag from its staged pc and q == 0
// words (the warp's slice ``sl``).
template <bool SMALL>
__device__ __forceinline__ void read_offsets(
    const Consts& c, const Slice& sl, long long b, int lane,
    int* __restrict__ out_off, float* __restrict__ wts,
    uint8_t* __restrict__ reject) {
  const int k = c.k, L = c.L, nk = c.nk;
  const int m = L - k + 1;
  const int nw = (m + 31) >> 5;
  const unsigned kmask = k >= 32 ? kFull : (1u << k) - 1u;
  float* pcs = sl.pcs;
  unsigned* ok2 = sl.ok2;
  // window products, kChunks chunks of 32 key positions at a time (their
  // product chains interleaved); probs go over pc once a group is read
  int left = -1, right = -1;
  for (int c0 = 0; c0 < nw; c0 += kChunks) {
    float prob[kChunks];
    bool in[kChunks];
#pragma unroll
    for (int g = 0; g < kChunks; ++g) {
      const int i = ((c0 + g) << 5) + lane;
      in[g] = i < m;
      prob[g] = in[g] ? pcs[i] : 1.0f;
    }
#pragma unroll 4
    for (int j = 1; j < k; ++j)
#pragma unroll
      for (int g = 0; g < kChunks; ++g)
        if (in[g])
          prob[g] = __fmul_rn(prob[g], pcs[((c0 + g) << 5) + lane + j]);
#pragma unroll
    for (int g = 0; g < kChunks; ++g) {
      const int ch = c0 + g;
      if (ch >= nw) break;
      const int i = (ch << 5) + lane;
      if (in[g]) {
        const unsigned z =
            __funnelshift_r(sl.zw[i >> 5], sl.zw[(i >> 5) + 1], i & 31) &
            kmask;
        prob[g] = z ? 1.0f : __fsub_rn(1.0f, prob[g]);
      }
      const unsigned b1 = __ballot_sync(kFull, in[g] && prob[g] < c.l1);
      const unsigned b2 = __ballot_sync(kFull, in[g] && prob[g] < c.l2);
      if (lane == 0) ok2[ch] = b2;
      if (left < 0 && b1) left = (ch << 5) + __ffs(b1) - 1;
      if (b1) right = (ch << 5) + 31 - __clz(b1);
    }
    __syncwarp();   // the group's windows are read: probs over pc
#pragma unroll
    for (int g = 0; g < kChunks; ++g)
      if (in[g]) pcs[((c0 + g) << 5) + lane] = prob[g];
  }
  __syncwarp();
  const bool any1 = left >= 0;
  if (!any1) {
    left = 0;
    right = m - 1;
  }
  // the ok2 words (word w in lane w where SMALL, else in shared memory)
  // and hw / lw: the highest set index at or below each word and the
  // lowest at or above it, a prefix max and a suffix min over the words
  unsigned mine = 0;
  int hw = -1, lw = INT_MAX;
  if (SMALL) {
    mine = lane < nw ? ok2[lane] : 0u;
    hw = mine ? (lane << 5) + 31 - __clz(mine) : -1;
    lw = mine ? (lane << 5) + __ffs(mine) - 1 : INT_MAX;
    for (int d = 1; d < 32; d <<= 1) {
      const int h = __shfl_up_sync(kFull, hw, d);
      const int l = __shfl_down_sync(kFull, lw, d);
      if (lane >= d) hw = max(hw, h);
      if (lane + d < 32) lw = min(lw, l);
    }
  } else {
    int carry = -1;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + lane;
      const unsigned word = w < nw ? ok2[w] : 0u;
      int h = word ? (w << 5) + 31 - __clz(word) : -1;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, h, d);
        if (lane >= d) h = max(h, o);
      }
      h = max(h, carry);
      if (w < nw) sl.hw[w] = h;
      carry = __shfl_sync(kFull, h, 31);
    }
    carry = INT_MAX;
    for (int w0 = ((nw - 1) >> 5) << 5; w0 >= 0; w0 -= 32) {
      const int w = w0 + lane;
      const unsigned word = w < nw ? ok2[w] : 0u;
      int l = word ? (w << 5) + __ffs(word) - 1 : INT_MAX;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_down_sync(kFull, l, d);
        if (lane + d < 32) l = min(l, o);
      }
      l = min(l, carry);
      if (w < nw) sl.lw[w] = l;
      carry = __shfl_sync(kFull, l, 0);
    }
    __syncwarp();
  }
  unsigned cnt = 0;
  for (int w = lane; w < nw; w += 32)
    cnt += __popc((SMALL ? mine : ok2[w]) & bits_in(w, left, right));
  const int pot = static_cast<int>(__reduce_add_sync(kFull, cnt));
  const bool valid = any1 && pot > 0 && right >= left;
  int* offs = sl.offs;
  if (!valid) {
    for (int i = lane; i < nk; i += 32) offs[i] = c.ladder[i];
  } else {
    const int usable = right - left + k;
    const int slots = usable - k + 1;
    int d2 = c.d2_tab[min(max(usable, 0), L)];
    d2 = min(slots, max(d2, 2));
    int desired = usable < L ? min(d2, nk) : nk;
    desired = max(min(desired, pot), 1);
    const int span = min(max(right - left, 0), m - 1);
    const int dm1 = min(max(desired - 1, 0), nk - 1);
    const float interval =
        c.div_tab[static_cast<long long>(span) * nk + dm1];
    const int interval_int = static_cast<int>(interval) + 1;
    // the ladder, 32 steps at a time, step i0 + l on lane l. Its
    // position: j_0 = left, j_i = min(max(j_{i-1} + 1, fl_i), m - 1)
    // with fl_i = floor(f_i + 0.5), f_i the float after i additions of
    // interval. Unclamped, j_i - i is the running max of left and fl_t -
    // t (t <= i), and the clamp only holds j at m - 1 once it gets there:
    // so only the float additions run in order, and the positions come
    // from a prefix max over the lanes. Then every lane finds its step's
    // candidates at once: the highest ok2 index in [prev + 3, j - 1] is
    // H, the highest at or below j - 1, where H >= prev + 3, and the
    // lowest in [j + 1, lim - 1] is the lowest at or above j + 1 where
    // that is <= lim - 1 (else -1); T = j where ok2 bit j (probs[j] < l2)
    // is set, else H; U = j, else the forward candidate. Only the prev
    // chain then runs step by step.
    float f = static_cast<float>(left);
    int run = left, prev = -1;
    for (int i0 = 0; i0 < desired; i0 += 32) {
      const int n = min(32, desired - i0);
      float mf = f;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        if (lane == l) mf = f;
        f = __fadd_rn(f, interval);
      }
      const int i = i0 + lane;
      int term = i > 0
                     ? static_cast<int>(floorf(__fadd_rn(mf, 0.5f))) - i
                     : INT_MIN;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, term, d);
        if (lane >= d) term = max(term, o);
      }
      term = max(term, run);
      run = __shfl_sync(kFull, term, 31);
      const int mj = min(i + term, m - 1);
      const int xh = min(mj - 1, m - 1), xl = mj + 1;
      const int hi_f = min(min(mj + interval_int, right) - 1, m - 1);
      const int wj = mj >> 5, wh = max(xh, 0) >> 5;
      const int wl = min(xl, m - 1) >> 5;
      unsigned bj, bh, bl;
      int hprev, lnext;
      if (SMALL) {
        bj = __shfl_sync(kFull, mine, wj);
        bh = __shfl_sync(kFull, mine, wh);
        bl = __shfl_sync(kFull, mine, wl);
        hprev = __shfl_sync(kFull, hw, wh - 1);
        lnext = __shfl_sync(kFull, lw, wl + 1);
        if (wh == 0) hprev = -1;
        if (wl + 1 >= nw) lnext = INT_MAX;
      } else {
        bj = ok2[wj];
        bh = ok2[wh];
        bl = ok2[wl];
        hprev = wh > 0 ? sl.hw[wh - 1] : -1;
        lnext = wl + 1 < nw ? sl.lw[wl + 1] : INT_MAX;
      }
      bh &= kFull >> (31 - (max(xh, 0) & 31));
      bl &= kFull << (min(xl, m - 1) & 31);
      int h = bh ? (wh << 5) + 31 - __clz(bh) : hprev;
      if (xh < 0) h = -1;
      int lo = bl ? (wl << 5) + __ffs(bl) - 1 : lnext;
      if (xl > hi_f || lo > hi_f) lo = -1;
      const bool hit = (bj >> (mj & 31)) & 1u;
      const int mt = hit ? mj : h, mu = hit ? mj : lo;
      // x = T where T >= prev + 3, else U (-1 where prev >= j); prev
      // becomes x where x > -1, else max(prev, j - 2), which is prev
      // where prev >= j
      int mx = -1;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const int sj = __shfl_sync(kFull, mj, l);
        const int st = __shfl_sync(kFull, mt, l);
        const int su = __shfl_sync(kFull, mu, l);
        if (l < n) {
          const bool a = prev < sj, b = prev <= st - 3;
          const int w = su > -1 ? su : max(prev, sj - 2);
          if (lane == l) mx = a ? (b ? st : su) : -1;
          prev = a ? (b ? st : w) : prev;
        }
      }
      if (lane < n) offs[i0 + lane] = mx;
    }
    for (int i = desired + lane; i < nk; i += 32) offs[i] = -1;
  }
  __syncwarp();
  float pae = 1.0f;
  for (int base = 0; base < nk; base += 32) {
    const int i = base + lane;
    float p = 1.0f;
    if (i < nk) {
      const int off = offs[i];
      p = off > -1 ? pcs[min(max(off, 0), m - 1)] : 1.0f;
      const float t = __fmul_rn(c.rng, __fsub_rn(1.0f, p));
      const int score =
          c.base_ks + static_cast<int>(floorf(__fadd_rn(t, 0.5f)));
      out_off[b * nk + i] = off;
      wts[b * nk + i] = __fmul_rn(static_cast<float>(score), c.inv_a);
    }
    // the ordered product: psel is 1 past nk, and a product by 1 is
    // exact, so every round takes 32 factors
    if (valid) {
#pragma unroll
      for (int l = 0; l < 32; ++l)
        pae = __fmul_rn(pae, __shfl_sync(kFull, p, l));
    }
  }
  if (lane == 0) reject[b] = valid && pae > 0.5f ? 1 : 0;
}

template <bool SMALL>
__global__ void quality_offsets_kernel(
    const int* __restrict__ q, const float* __restrict__ pc, int B, int wpb,
    Consts c, int* __restrict__ out_off, float* __restrict__ wts,
    uint8_t* __restrict__ reject) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * wpb + warp;
  if (b >= B) return;
  const int L = c.L;
  const Slice s = slice(smem, warp, L, L - c.k + 1, c.nk);
  const int nz = (L + 31) >> 5;
  // kStage chunks of 32 bases at a time, their loads in flight together
  for (int c0 = 0; c0 < nz; c0 += kStage) {
    float pv[kStage];
    bool zv[kStage];
#pragma unroll
    for (int g = 0; g < kStage; ++g) {
      const int i = ((c0 + g) << 5) + lane;
      pv[g] = i < L ? __ldg(pc + b * L + i) : 0.0f;
      zv[g] = i < L && __ldg(q + b * L + i) == 0;
    }
#pragma unroll
    for (int g = 0; g < kStage; ++g) {
      const int ch = c0 + g;
      if (ch >= nz) break;
      const int i = (ch << 5) + lane;
      if (i < L) s.pcs[i] = pv[g];
      const unsigned zb = __ballot_sync(kFull, zv[g]);
      if (lane == 0) s.zw[ch] = zb;
    }
  }
  if (lane == 0) s.zw[nz] = 0u;
  __syncwarp();
  read_offsets<SMALL>(c, s, b, lane, out_off, wts, reject);
}

template <bool SMALL>
__global__ void quality_offsets_packed_kernel(
    const long long* __restrict__ words, int W8,
    const int* __restrict__ palette, const float* __restrict__ pcpal, int B,
    int wpb, Consts c, int* __restrict__ out_off, float* __restrict__ wts,
    uint8_t* __restrict__ reject) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * wpb + warp;
  if (b >= B) return;
  const int L = c.L;
  const Slice s = slice(smem, warp, L, L - c.k + 1, c.nk);
  // lane v < 16 holds palette entry v: its probability, and whether its
  // quality is 0
  const float pcv = lane < 16 ? pcpal[lane] : 1.0f;
  const unsigned zpal = __ballot_sync(kFull, lane < 16 && palette[lane] == 0);
  const int nz = (L + 31) >> 5;
  const long long* row = words + b * W8;
  // a lane loads one word (8 bases) of each 256-base block; chunk g of 32
  // bases in the block takes its words from lanes 4g .. 4g + 3
  for (int w0 = 0; w0 < W8; w0 += 32 * kWords) {
    unsigned wv[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int w = w0 + 32 * u + lane;
      wv[u] = w < W8 ? static_cast<unsigned>(__ldg(row + w)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int ch = ((w0 + 32 * u) >> 2) + g;
        if (ch >= nz) break;
        const int i = (ch << 5) + lane;
        const unsigned w = __shfl_sync(kFull, wv[u], 4 * g + (lane >> 3));
        const int nib = (w >> (4 * (i & 7))) & 15;
        const float p = __shfl_sync(kFull, pcv, nib);
        if (i < L) s.pcs[i] = p;
        const unsigned zb =
            __ballot_sync(kFull, i < L && ((zpal >> nib) & 1u));
        if (lane == 0) s.zw[ch] = zb;
      }
    }
  }
  if (lane == 0) s.zw[nz] = 0u;
  __syncwarp();
  read_offsets<SMALL>(c, s, b, lane, out_off, wts, reject);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Reads a block: 8, fewer where the batch would not fill every SM or a
// warp's slice is large; 0 if one warp's slice is past 227 KB.
int warps_a_block(int B, size_t ws) {
  const int by_smem = static_cast<int>(kMaxSmem / ws);
  const int sms = sm_count();
  const int by_batch = (B + sms - 1) / sms;
  return max(0, min(kMaxWarps, min(by_smem, max(1, by_batch))));
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int B, int wpb, size_t ws,
                   cudaStream_t stream, Args... args) {
  const size_t smem = ws * wpb;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<(B + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a read takes at (L, k, nk); the wrapper refuses reads past
// a block's 227 KB (L ~ 35,000 bases at the long path's key density).
long long quality_offsets_smem(int L, int k, int nk) {
  return static_cast<long long>(warp_bytes(L, L - k + 1, nk));
}

// B reads: q (B, L) int32, pc (B, L) float32, row-major; d2_tab (L + 1,)
// int32, div_tab (m, nk) float32, ladder (nk,) int32. out_off (B, nk)
// int32, wts (B, nk) float32, reject (B,) bool bytes. 1 <= k <= 32.
cudaError_t quality_offsets_launch(const int* q, const float* pc, int B,
                                   int L, int k, int nk, const int* d2_tab,
                                   const float* div_tab, const int* ladder,
                                   float l1, float l2, int base_ks, float rng,
                                   float inv_a, int* out_off, float* wts,
                                   uint8_t* reject, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const int m = L - k + 1;
  if (k < 1 || k > 32 || m < 1 || nk < 1) return cudaErrorInvalidValue;
  const size_t ws = warp_bytes(L, m, nk);
  const int wpb = warps_a_block(B, ws);
  if (wpb < 1) return cudaErrorInvalidValue;
  const Consts c{L, k, nk, d2_tab, div_tab, ladder, l1, l2, base_ks, rng,
                 inv_a};
  if (m <= kSmallM)
    return launch(quality_offsets_kernel<true>, B, wpb, ws, stream, q, pc, B,
                  wpb, c, out_off, wts, reject);
  return launch(quality_offsets_kernel<false>, B, wpb, ws, stream, q, pc, B,
                wpb, c, out_off, wts, reject);
}

// The packed route: words (B, W8) int64 holding uint32 words of 8 nibbles
// each (base 8w + s in bits 4s..4s+3), palette (16,) int32 phred, pcpal
// (16,) float32 its probability correct; the rest as
// quality_offsets_launch.
cudaError_t quality_offsets_packed_launch(
    const long long* words, int W8, const int* palette,
    const float* pcpal, int B, int L, int k, int nk, const int* d2_tab,
    const float* div_tab, const int* ladder, float l1, float l2, int base_ks,
    float rng, float inv_a, int* out_off, float* wts, uint8_t* reject,
    cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const int m = L - k + 1;
  if (k < 1 || k > 32 || m < 1 || nk < 1 || W8 * 8 < L)
    return cudaErrorInvalidValue;
  const size_t ws = warp_bytes(L, m, nk);
  const int wpb = warps_a_block(B, ws);
  if (wpb < 1) return cudaErrorInvalidValue;
  const Consts c{L, k, nk, d2_tab, div_tab, ladder, l1, l2, base_ks, rng,
                 inv_a};
  if (m <= kSmallM)
    return launch(quality_offsets_packed_kernel<true>, B, wpb, ws, stream,
                  words, W8, palette, pcpal, B, wpb, c, out_off, wts, reject);
  return launch(quality_offsets_packed_kernel<false>, B, wpb, ws, stream,
                words, W8, palette, pcpal, B, wpb, c, out_off, wts, reject);
}

}  // extern "C"
