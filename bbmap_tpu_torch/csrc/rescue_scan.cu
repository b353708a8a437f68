// Mate rescue's window scan and acceptance walk, one launch a batch.
//
// Replaces the JAX package's _rescue_stage (bbmap_tpu/ops/rescue_device.py:
// 37-110, one jitted XLA program of two lax.scans: the per-offset
// statistics over the read positions, :63, and the acceptance walk over
// the scan positions, :108), the brute-force windowed scan of
// AbstractMapThread.quickRescue. The port ran both scans as Python loops
// of tensor steps: ~12 launches a read position and ~20 a scan position,
// some 39,000 for one call at Lm = 150, N_OFF = 1,536.
//
// The function, per job (a mate read of Lm codes 0..4, 4 = N; a window of
// the genome from flat position lo; n candidate offsets; the scan
// coordinate of the ideal start; the direction; a mismatch bound):
//
//   window p in [0, N_OFF + Lm): the genome's code at lo + p, "bad" where
//     that base is N or outside [0, G)
//   offset t in [0, N_OFF): good(j) = read[j] == window[t + j], neither
//     an N nor bad; mism[t] = # not good, contig[t] = longest run of good,
//     score[t] = (Lm - mism[t]) + contig[t]
//   walk k = 0, 1, ..., N_OFF - 1 (t = k scanning right, t = n - 1 - k
//     scanning left; a step with t outside [0, n) accepts nothing):
//     accept when k <= klim, mism <= min_mm and (score > best_s, or
//     score == best_s and |t - ideal_k| < best_a); an accepted step sets
//     min_mm, best_s, best_a, best_k = k, and one with mism 0 also sets
//     klim = min(klim, kref + |t - ideal_k|) (kref = ideal_k scanning
//     right, n - 1 - ideal_k scanning left). Start: min_mm = max_mm + 1,
//     best_s 0, best_a 2^30, best_k -1, klim N_OFF.
//   out: best_k (-1: nothing accepted) and min_mm, int32.
//
// Design: a block a job (a batch holds tens to a few thousand jobs).
//  - Bits, not bytes. The block stages the window straight from the 2-bit
//    packed genome as DeviceIndex holds it (uint32 words in int64, 16
//    bases a word), each staged word the funnel shift of two genome words
//    that aligns it to lo, and beside each a word of bad bits (N mask or
//    off the genome) at the even bit of each base; it packs the read once
//    the same way (a byte a thread, the 16 lanes of a word ORed by
//    shuffles), with a bit for each base that is not N. Only the offsets
//    the walk can read, t < min(n, N_OFF), are staged and scanned.
//  - A word of 16 positions a step. For offset t, read word j meets the
//    window word at t + 16 j: a funnel shift of two staged words, XOR the
//    read's word, folded to one bit a base (x | x >> 1); the good bases
//    are the read's ok bits without those and without the window's bad
//    bits, and mism = Lm - popcount(good). min_mm starts at max_mm + 1 and
//    only falls, so an offset whose misses pass that bound is never
//    accepted: its count stops there (at max_mm 32 and random sequence
//    after ~3 of the 10 words at Lm = 150) and its stored mism stays past
//    the bound. Only the offsets that stay within it take the longest run,
//    carried from word to word (the word's leading run extends it, its
//    trailing run starts the next; the runs inside a word counted by
//    shifting where its popcount could beat the best so far).
//  - The walk on one warp by ballots. The block's warps first mark, for
//    each chunk of 32 walk steps, the steps whose offset stayed within the
//    bound (a ballot a chunk, all warps at once); the walk visits only the
//    chunks with a mark, found 32 chunks at a time by a ballot. The walk
//    is order dependent (each step reads the min_mm, best and klim the
//    accepts before it left), so within a chunk, a step a lane, each
//    marked lane whose step dominates the current state (the accept test
//    above) votes; the lowest voter is the next accept (the serial walk
//    rejects every step before it, all tested against the same state, and
//    the state changes only at an accept); its values are broadcast and
//    the state is updated, until no lane votes. No lane at or before an
//    accept votes again: the test is a strict order on (score, -absdif)
//    with bounds that only tighten, so a step that did not dominate the
//    state before the accept does not dominate it after, and the accepted
//    step does not dominate itself. The walk stops at k = min(n, N_OFF)
//    (no later t lies in [0, n)) or once k passes klim (klim never
//    grows). Where a thread walked up to 1,536 dependent steps, the warp
//    takes a round an accept and a chunk with a mark.
//
// What bounds it: at the main path's sizes, latency: staging and one
// job's scan on a block of 8 warps, then the walk on one. A job is at most
// n x Lm compares (n <= 1,536, Lm = 150: 230,400, 15,360 word steps, most
// of them cut at the bound) and a walk of at most N_OFF steps; the bytes
// are the window's words and the read, a few hundred bytes a job.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEven = 0x55555555u;   // bit 2i: base i of a word
constexpr size_t kMaxSmem = 232448;       // 227 KB a block on sm_90
constexpr int kBigA = 1 << 30;

__host__ __device__ inline int read_words(int Lm) { return (Lm + 15) >> 4; }

// Staged window words an offset count needs: the words under offsets
// t < used, and one more for the funnel shift.
__host__ __device__ inline int window_words(int used, int Lm) {
  return used > 0 ? ((used - 1) >> 4) + read_words(Lm) + 1 : 0;
}

__host__ __device__ inline int chunks(int used) { return (used + 31) >> 5; }

__host__ __device__ inline size_t smem_bytes(int Lm, int N_OFF) {
  // mism and score (int32 an offset), the window's codes and bad bits, the
  // read's codes and ok bits (a uint32 word each), a mark word a chunk
  const size_t bytes = 8 * static_cast<size_t>(N_OFF) +
                       8 * static_cast<size_t>(window_words(N_OFF, Lm)) +
                       8 * static_cast<size_t>(read_words(Lm)) +
                       4 * static_cast<size_t>(chunks(N_OFF));
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// Bits 0 .. 15 of x to the even bits 0, 2, .., 30.
__device__ inline unsigned spread_even(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & kEven;
}

struct Genome {
  const long long* gpack;
  const long long* nmask;
  long long nwg;   // the gpack words holding a genome base: ceil(G / 16)
  long long nwn;   // the nmask words: ceil(G / 32)
  long long G;
  int has_n;
};

// gpack word w (0 past either end: those positions are bad anyway).
__device__ inline unsigned genome_word(const Genome& g, long long w) {
  return static_cast<unsigned long long>(w) <
                 static_cast<unsigned long long>(g.nwg)
             ? static_cast<unsigned>(g.gpack[w])
             : 0u;
}

__device__ inline unsigned n_word(const Genome& g, long long i) {
  return static_cast<unsigned long long>(i) <
                 static_cast<unsigned long long>(g.nwn)
             ? static_cast<unsigned>(g.nmask[i])
             : 0u;
}

// The bad bits of genome positions p0 .. p0 + 15 (N, or outside [0, G))
// as bits 0 .. 15.
__device__ inline unsigned bad_bits(const Genome& g, long long p0) {
  unsigned nb = 0u;
  if (g.has_n)
    nb = __funnelshift_r(n_word(g, p0 >> 5), n_word(g, (p0 >> 5) + 1),
                         static_cast<unsigned>(p0 & 31));
  const long long a = p0 < 0 ? -p0 : 0;               // first on the genome
  const long long b = g.G - p0;                       // first past it
  unsigned in = 0u;
  if (a < 16 && b > a) {
    const int hi = b < 16 ? static_cast<int>(b) : 16;
    in = ((1u << hi) - 1u) & ~((1u << a) - 1u);
  }
  return (nb | ~in) & 0xffffu;
}

__global__ void __launch_bounds__(kThreads) rescue_scan_kernel(
    Genome gen, const uint8_t* __restrict__ reads,
    const int* __restrict__ lo, const int* __restrict__ nn,
    const int* __restrict__ ideal_k, const uint8_t* __restrict__ right,
    const int* __restrict__ max_mm, int Lm, int N_OFF,
    int* __restrict__ best_k_out, int* __restrict__ min_mm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = read_words(Lm);
  int* mism = reinterpret_cast<int*>(smem);
  int* score = mism + N_OFF;
  unsigned* cw = reinterpret_cast<unsigned*>(score + N_OFF);
  unsigned* bw = cw + window_words(N_OFF, Lm);
  unsigned* rw = bw + window_words(N_OFF, Lm);
  unsigned* ok = rw + nw;
  unsigned* mark = ok + nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int job = blockIdx.x;
  const int n = nn[job];
  // offsets the walk reads: t in [0, n) clamped to N_OFF - 1
  const int used = max(0, min(n, N_OFF));
  const int staged = window_words(used, Lm);
  const long long base = lo[job];
  // min_mm starts here and never grows: an offset past it is never taken
  const int lim = max_mm[job] + 1;
  // window word i: positions lo + 16 i .. + 15, the funnel shift of the
  // two genome words under it (base >> 4 and base & 15 floor for base < 0)
  const unsigned gsh = static_cast<unsigned>(base & 15) * 2;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const long long gw = (base >> 4) + i;
    cw[i] = __funnelshift_r(genome_word(gen, gw), genome_word(gen, gw + 1),
                            gsh);
    bw[i] = spread_even(bad_bits(gen, base + 16LL * i));
  }
  // the read: a byte a thread, a word's 16 lanes ORed together
  const uint8_t* rj = reads + static_cast<long long>(job) * Lm;
  for (int p0 = 0; p0 < 16 * nw; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    unsigned code = 0u, okb = 0u;
    if (p < Lm) {
      const unsigned c = rj[p];
      if (c <= 3u) {
        code = c << (2 * (p & 15));
        okb = 1u << (2 * (p & 15));
      }
    }
    for (int d = 1; d < 16; d <<= 1) {
      code |= __shfl_xor_sync(kFull, code, d);
      okb |= __shfl_xor_sync(kFull, okb, d);
    }
    if ((p & 15) == 0 && p < 16 * nw) {
      rw[p >> 4] = code;
      ok[p >> 4] = okb;
    }
  }
  __syncthreads();

  const int pad = 16 * nw - Lm;   // never good, never a miss
  for (int t = threadIdx.x; t < used; t += blockDim.x) {
    const int q = t >> 4;
    const unsigned sh = static_cast<unsigned>(t & 15) * 2;
    // the misses, word by word, until they pass lim
    int miss = -pad;
    unsigned c0 = cw[q], b0 = bw[q];
    for (int j = 0; j < nw && miss <= lim; ++j) {
      const unsigned c1 = cw[q + j + 1], b1 = bw[q + j + 1];
      const unsigned x = __funnelshift_r(c0, c1, sh) ^ rw[j];
      const unsigned g = ok[j] & ~(x | (x >> 1) | __funnelshift_r(b0, b1, sh));
      miss += __popc(~g & kEven);
      c0 = c1;
      b0 = b1;
    }
    int best = 0;
    if (miss <= lim) {   // within the bound: the longest run of good bases
      int cur = 0;
      c0 = cw[q];
      b0 = bw[q];
      for (int j = 0; j < nw; ++j) {
        const unsigned c1 = cw[q + j + 1], b1 = bw[q + j + 1];
        const unsigned x = __funnelshift_r(c0, c1, sh) ^ rw[j];
        const unsigned g =
            ok[j] & ~(x | (x >> 1) | __funnelshift_r(b0, b1, sh));
        c0 = c1;
        b0 = b1;
        if (g == kEven) {              // all 16 good: the run goes on
          cur += 16;
          continue;
        }
        const unsigned ng = ~g & kEven;
        best = max(best, cur + ((__ffs(ng) - 1) >> 1));   // the leading run
        if (__popc(g) > best) {                           // runs inside
          int r = 0;
          for (unsigned y = g; y; y &= y >> 2) ++r;
          best = max(best, r);
        }
        cur = __clz(ng) >> 1;                              // the trailing run
      }
      best = max(best, cur);
    }
    mism[t] = miss;
    score[t] = (Lm - miss) + best;
  }
  __syncthreads();

  // a mark a walk step whose offset stayed within lim: a word a chunk of 32
  // steps, the block's warps over the chunks
  const bool rt = right[job] != 0;
  const int nch = chunks(used);
  for (int c = warp; c < nch; c += blockDim.x >> 5) {
    const int k = 32 * c + lane;
    bool in = false;
    if (k < used) {
      const int t = rt ? k : (n - 1) - k;
      in = mism[min(t, N_OFF - 1)] <= lim;
    }
    const unsigned m = __ballot_sync(kFull, in);
    if (lane == 0) mark[c] = m;
  }
  __syncthreads();

  if (warp != 0) return;
  const int ik = ideal_k[job];
  const int kref = rt ? ik : (n - 1) - ik;
  int min_mm = lim, best_s = 0, best_a = kBigA, best_k = -1;
  int klim = N_OFF;
  for (int c0 = 0; c0 < nch && 32 * c0 <= klim; c0 += 32) {
    // the marked chunks among the next 32
    const unsigned mine = c0 + lane < nch ? mark[c0 + lane] : 0u;
    unsigned live = __ballot_sync(kFull, mine != 0u);
    while (live) {
      const int at_c = __ffs(live) - 1;
      live &= live - 1u;
      const int k0 = 32 * (c0 + at_c);
      if (k0 > klim) break;
      const int k = k0 + lane;
      int m = 0, s = 0, a = 0;
      if (k < used) {
        const int t = rt ? k : (n - 1) - k;
        const int ts = min(t, N_OFF - 1);
        m = mism[ts];
        s = score[ts];
        a = abs(t - ik);
      }
      const unsigned marked = __shfl_sync(kFull, mine, at_c);
      for (;;) {
        const bool dom = ((marked >> lane) & 1u) && k <= klim &&
                         m <= min_mm &&
                         (s > best_s || (s == best_s && a < best_a));
        const unsigned hit = __ballot_sync(kFull, dom);
        if (hit == 0u) break;
        const int at = __ffs(hit) - 1;   // the lowest voter: the next accept
        min_mm = __shfl_sync(kFull, m, at);
        best_s = __shfl_sync(kFull, s, at);
        best_a = __shfl_sync(kFull, a, at);
        best_k = k0 + at;
        if (min_mm == 0) klim = min(klim, kref + best_a);
      }
    }
  }
  if (lane == 0) {
    best_k_out[job] = best_k;
    min_mm_out[job] = min_mm;
  }
}

}  // namespace

extern "C" {

// Shared memory a block takes at (Lm, N_OFF); the wrapper refuses shapes
// past a block's 227 KB.
long long rescue_scan_smem(int Lm, int N_OFF) {
  return static_cast<long long>(smem_bytes(Lm, N_OFF));
}

// R jobs: reads (R, Lm) uint8 codes, lo / n / ideal_k / max_mm (R,) int32,
// right (R,) bool bytes; gpack (>= G/16 words) and nmask (>= G/32 words)
// int64 holding uint32 words. best_k and min_mm (R,) int32.
cudaError_t rescue_scan_launch(const long long* gpack, const long long* nmask,
                               long long G, int has_n, const uint8_t* reads,
                               const int* lo, const int* n, const int* ideal_k,
                               const uint8_t* right, const int* max_mm, int R,
                               int Lm, int N_OFF, int* best_k, int* min_mm,
                               cudaStream_t stream) {
  if (R <= 0) return cudaSuccess;
  if (Lm < 1 || N_OFF < 1 || G < 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Lm, N_OFF);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rescue_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const Genome gen{gpack, nmask, (G + 15) >> 4, (G + 31) >> 5, G, has_n};
  rescue_scan_kernel<<<R, kThreads, smem, stream>>>(
      gen, reads, lo, n, ideal_k, right, max_mm, Lm, N_OFF, best_k, min_mm);
  return cudaGetLastError();
}

}  // extern "C"
