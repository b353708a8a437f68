// The candidate table's gapless streak score: each (read, candidate) scored
// at its modal diagonal against the 2-bit packed genome, one launch a
// batch, with no (B, K, L) tensor.
//
// Replaces the scoring half of the JAX package's finalize_stage
// (bbmap_tpu/align/quickmap_device.py:1291, its extract_ref_codes at :244
// and gapless.score_match_sub_vec, fused by XLA into one program;
// reference: MultiStateAligner11ts.scoreNoIndels:1885-1952).
//
// The function, per (read b, candidate c), over j = 0 .. L-1:
//
//   the read's code: rcodes[b, j] on the plus strand; on the minus strand
//     rcodes[b, L-1-j], complemented where it is a base (3 - code; N stays)
//   the genome's code at pos = mode[b, c] + j from the 2-bit words (gpack,
//     16 bases a word), N where pos < 0, pos >= G or (has_n) the N mask's
//     bit is set (nmask, 32 bases a word)
//   eq = codes equal and the genome base not N; match = eq and the read
//     base not N; sub = neither eq nor an N on either side; any other
//     position is skipped: it scores 0 and leaves the run state as it was
//   the streak rule of gapless.score_no_indels: a match scores match2
//     after a match, else match; a sub scores sub, sub2 from the 2nd sub in
//     a row, sub3 past LIMIT_FOR_COST_3 subs in a row.
//
// That rule, one position after another, is what score_match_sub_vec's
// closed form computes with its running maxima.
//
// Design: a word of 16 window positions a step, with bit masks. A block
// copies its reads' bytes to shared memory (aligned 32-bit loads), then
// packs each read once for all its candidates, four bytes at a step: its
// codes as 2-bit words of 16 bases on both strands (the minus strand
// reversed and complemented) with a 16-bit word of its N positions beside
// each. For the window word at genome position p, the genome's 16
// codes are a funnel shift of two consecutive gpack words, and x = read ^
// genome gives equality as one bit a position. The positions that score
// (in the window, on the genome, no N on either side) are moved down in
// order past the skipped ones (a shift past the leading ones, one step a
// hole: skips are transparent to the run state), and the word scores
// with popcounts: matches after a match are popc(M & (M << 1 | carry));
// subs that open a run popc(S & ~(E << 1)); subs past lim3 in their run
// the ends of lim3 + 1 ones in a row of E (ANDs of shifted copies,
// doubling), where E is the word's subs above lim3 bits of the sub run
// carried in. The state carried out is the last position's type and the
// trailing sub run's length, capped at lim3 (past it every sub scores
// sub3).
//
// Two mappings (quickmap_device.gapless_mapping picks by the number of
// candidates):
//  - "thread": a thread a candidate walks its window a word at a time,
//    loading the next genome word while it scores this one; blocks of 256
//    threads hold 256 / K reads, the K threads of a read pack it. For many
//    candidates (the main path's 524,288), where a thread a candidate
//    fills the card.
//  - "warp": a warp a candidate; each lane scores a contiguous chunk of
//    the window's words from a fresh state and keeps a summary (the score,
//    the first scored position's type, the subs before the chunk's first
//    match, whether it has a match, the state out). A tree over the lanes
//    joins neighbouring chunks in order: a chunk's points depend on the
//    state coming in only through its leading run (a leading match scores
//    match2 after a match; a leading sub run continues the incoming
//    streak), so the join adds a correction computed in closed form. For
//    few candidates (the long path's 32 x 8 windows of 6,000), where a
//    thread a candidate left all but one SM idle.
//
// What bounds it: bytes (the read codes, the candidates' modes and
// strands, the genome words under the windows and the scores: ~18 MB at
// 65,536 x 8 x 150). What holds it well above that bound is issue: the
// word's instructions and the reads' packing; with few candidates, the
// latency of one warp's walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNone = 0, kMatch = 1, kSub = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;          // the thread mapping's block
constexpr int kWarps = 8;              // warps a block in the warp mapping
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kMaxSmem = 232448;    // 227 KB a block on sm_90

struct Points {
  int match, match2, sub, sub2, sub3, lim3;
};

// The run state carried from position to position: the last scored
// position's type and the length of the sub run it ends, capped at lim3.
struct Run {
  int last, t;
};

// A chunk's leading positions: the type of its first scored position, the
// subs before its first match (capped at lim3), and whether it has one.
struct Lead {
  int first, lead;
  bool has_match;
};

// The sum of a sub run's points over its first m subs.
__device__ inline int run_points(int m, const Points& p) {
  if (m <= 0) return 0;
  return p.sub + p.sub2 * (min(m, p.lim3) - 1) + p.sub3 * max(m - p.lim3, 0);
}

// What a chunk's leading sub run of n subs (scored from a fresh state)
// gains when it continues an incoming run of t subs (both capped at lim3:
// past it the gain no longer changes).
__device__ inline int run_gain(int t, int n, const Points& p) {
  return run_points(t + n, p) - run_points(t, p) - run_points(n, p);
}

// Scores the word's positions that score (`scored`: in the window, on the
// genome and no N on either side; eq: codes equal) from the state s, which
// it advances; with kLead, it also records the chunk's leading positions.
// Skipped positions are transparent, so the scored ones are first moved
// down in order past them (a shift past the leading ones, then one step a
// hole), and the word scores as a run of that many positions.
template <bool kLead>
__device__ inline int score_word(unsigned eq, unsigned scored, Run& s,
                                 Lead& ld, const Points& p) {
  if (scored == 0) return 0;             // nothing scored: state unchanged
  const int a = __ffs(scored) - 1;
  unsigned x = scored >> a;
  eq >>= a;
  for (unsigned holes = ~x & ((2u << (31 - __clz(x))) - 1u); holes;) {
    const unsigned low = (1u << (31 - __clz(holes))) - 1u;
    eq = (eq & low) | ((eq >> 1) & ~low);
    x = (x & low) | ((x >> 1) & ~low);
    holes &= low;
  }
  // x: a prefix of ones, one a scored position
  const int T = p.lim3;
  const unsigned M = eq & x, S = ~eq & x;
  const int nm = __popc(M);
  const int nmm = __popc(M & ((M << 1) | (s.last == kMatch ? 1u : 0u)));
  // E: the word's subs above T bits holding the sub run carried in
  const int tin = s.last == kSub ? s.t : 0;
  const unsigned E = (S << T) | (((1u << tin) - 1u) << (T - tin));
  const int ns = __popc(S);
  const int n1 = __popc(S & ~((E << 1) >> T));        // subs opening a run
  unsigned R = E;                                      // runs of T + 1
  for (int have = 1; have < T + 1;) {
    const int d = min(have, T + 1 - have);
    R &= R << d;
    have += d;
  }
  const int n3 = __popc(R >> T);                       // subs past lim3
  if (kLead) {
    if (ld.first == kNone) ld.first = (M & 1u) ? kMatch : kSub;
    if (!ld.has_match) {
      ld.lead = min(ld.lead + (M ? __ffs(M) - 1 : ns), T);
      ld.has_match = M != 0;
    }
  }
  const int hi = 31 - __clz(x);
  if ((M >> hi) & 1u) {
    s.last = kMatch;
    s.t = 0;
  } else {
    s.last = kSub;
    s.t = min(__clz(~(E << (31 - T - hi))), T);
  }
  return p.match * nm + (p.match2 - p.match) * nmm + p.sub * n1 +
         p.sub2 * (ns - n1 - n3) + p.sub3 * n3;
}

// Bits 0, 2, .., 30 of x to bits 0 .. 15.
__device__ inline unsigned even_bits(unsigned x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// Bits a .. b - 1 of a 16-bit word (clamped to it).
__device__ inline unsigned span_bits(int a, int b) {
  a = max(a, 0);
  b = min(b, 16);
  return a >= b ? 0u : ((1u << b) - 1u) & ~((1u << a) - 1u);
}

struct Genome {
  const long long* gpack;
  const long long* nmask;
  long long nwg;   // the gpack words holding a genome base: ceil(G / 16)
  long long nwn;   // the nmask words
  long long G;
  int has_n;
};

// gpack word w: the 2-bit codes of genome positions [16 w, 16 w + 16) (0
// past either end: those positions are off the genome, so skipped).
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

// The block's reads, rows b0 .. b0 + nr - 1 of rcodes (contiguous), copied
// to shared memory as the aligned 32-bit words that hold them; returns
// the byte offset of row b0 in the copy. A word read holds a byte of the
// rows, so no load leaves their allocation's 4-byte granules.
__device__ inline int stage_rows(const uint8_t* __restrict__ rcodes,
                                 long long b0, int nr, int L,
                                 unsigned* buf) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(rcodes + b0 * L);
  const uintptr_t astart = start & ~static_cast<uintptr_t>(3);
  const int n = static_cast<int>((start + static_cast<uintptr_t>(nr) * L -
                                  astart + 3) >> 2);
  const unsigned* src = reinterpret_cast<const unsigned*>(astart);
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = src[i];
  buf[n] = 0u;                            // read past by the funnel shifts
  return static_cast<int>(start - astart);
}

// Bytes lo .. lo + 3 of a staged read whose byte 0 is at byte offset o of
// buf, as a little-endian word with 0 in the bytes outside [0, L).
__device__ inline unsigned read_bytes(const unsigned* buf, int o, int L,
                                      int lo) {
  if (lo <= -4 || lo >= L) return 0u;
  const int at = o + lo;                  // >= o - 3 >= -3
  const int wi = at >> 2;
  unsigned v = __funnelshift_r(wi >= 0 ? buf[wi] : 0u, buf[wi + 1],
                               static_cast<unsigned>(at & 3) * 8);
  if (lo < 0) v &= ~0u << (-lo * 8);
  if (L - lo < 4) v &= (1u << (8 * (L - lo))) - 1u;
  return v;
}

// Four read bytes (codes 0..3, above 3 an N) to 8 code bits and 4 N bits.
__device__ inline void pack4(unsigned u, unsigned& code, unsigned& nb) {
  const unsigned c = u & 0x03030303u;
  code = (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xffu;
  const unsigned n = __vcmpgtu4(u, 0x03030303u) & 0x01010101u;
  nb = (n | (n >> 7) | (n >> 14) | (n >> 21)) & 0xfu;
}

// A staged read's 2-bit words of 16 bases, (code, N bits) a word, on both
// strands (the minus strand reversed and complemented): words[s * nwr +
// w], packed by the threads `first`, `first` + step, ... of the block.
__device__ inline void pack_read(const unsigned* buf, int o, int L, int nwr,
                                 int first, int step, uint2* words) {
  for (int i = first; i < 2 * nwr; i += step) {
    const bool minus = i >= nwr;
    const int w = minus ? i - nwr : i;
    unsigned code = 0, nb = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 16 * w + 4 * k;      // the group's first window position
      unsigned u = minus ? __byte_perm(read_bytes(buf, o, L, L - 4 - j), 0,
                                       0x0123) ^ 0x03030303u
                         : read_bytes(buf, o, L, j);
      unsigned c, n;
      pack4(u, c, n);
      code |= c << (8 * k);
      nb |= n << (4 * k);
    }
    words[i] = make_uint2(code, nb);
  }
}

// Bytes of shared memory a read takes: its packed words on both strands
// (8 B a word) and its staged bytes.
__host__ __device__ inline size_t read_smem(int L) {
  return 2 * 8 * static_cast<size_t>((L + 15) >> 4) + L;
}

// A candidate's window at genome position p0: its positions on the
// genome are jlo .. jhi - 1 (the others are skipped).
struct Window {
  long long p0;
  int jlo, jhi;
  unsigned sh;
};

__device__ inline Window window_of(long long p0, int L, long long G) {
  Window win;
  win.p0 = p0;
  win.jlo = static_cast<int>(min(max(-p0, 0LL), static_cast<long long>(L)));
  win.jhi = static_cast<int>(min(max(G - p0, 0LL), static_cast<long long>(L)));
  win.sh = static_cast<unsigned>(p0 & 15);
  return win;
}

// Scores window words w0 .. w1 - 1 of a candidate from the state s: the
// genome's codes a funnel shift of gpack words loaded one ahead, its N bits
// (where the genome has N) a funnel shift of nmask words.
template <bool kLead>
__device__ inline int score_words(const uint2* rw, const Window& win, int w0,
                                  int w1, const Genome& g, Run& s, Lead& ld,
                                  const Points& p) {
  long long gw = (win.p0 >> 4) + w0;
  unsigned lo = genome_word(g, gw), hi = genome_word(g, gw + 1);
  int score = 0;
  for (int w = w0; w < w1; ++w, ++gw) {
    const unsigned next = w + 1 < w1 ? genome_word(g, gw + 2) : 0u;
    const int j0 = w << 4;
    const uint2 r = rw[w];
    const unsigned x = r.x ^ __funnelshift_r(lo, hi, 2 * win.sh);
    const unsigned eq = ~even_bits(x | (x >> 1)) & 0xffffu;
    unsigned n = r.y;
    if (g.has_n) {
      const long long pos = win.p0 + j0;
      const long long i = pos >> 5;
      n |= __funnelshift_r(n_word(g, i), n_word(g, i + 1),
                           static_cast<unsigned>(pos & 31)) & 0xffffu;
    }
    const unsigned scored = span_bits(win.jlo - j0, win.jhi - j0) & ~n;
    score += score_word<kLead>(eq, scored, s, ld, p);
    lo = hi;
    hi = next;
  }
  return score;
}

__global__ void __launch_bounds__(kThreads) gapless_thread_kernel(
    const uint8_t* __restrict__ rcodes, int B, int L, int K, int R,
    const int* __restrict__ mode, const int* __restrict__ strand, Genome g,
    Points pts, int* __restrict__ scores) {
  extern __shared__ uint2 words[];
  const int nwr = (L + 15) >> 4;
  const int r = threadIdx.x / K, k = threadIdx.x - r * K;
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const long long b = b0 + r;
  // the block's reads staged, then the K threads of read r pack it
  unsigned* buf = reinterpret_cast<unsigned*>(words + R * 2 * nwr);
  const int o = stage_rows(rcodes, b0, static_cast<int>(min(
                               static_cast<long long>(R), B - b0)), L, buf);
  __syncthreads();
  uint2* mine = words + r * 2 * nwr;
  if (b < B) pack_read(buf, o + r * L, L, nwr, k, K, mine);
  __syncthreads();
  if (b >= B) return;
  const long long t = b * K + k;
  const Window win = window_of(mode[t], L, g.G);
  Run s{kNone, 0};
  Lead ld{kNone, 0, false};
  scores[t] = score_words<false>(mine + (strand[t] != 0 ? nwr : 0), win,
                                     0, nwr, g, s, ld, pts);
}

// A chunk's summary, carried in two ints for the shuffles.
struct Chunk {
  int score;
  Run out;
  Lead ld;
};

__device__ inline int pack_info(const Chunk& c) {
  return c.ld.first | (c.ld.has_match ? 4 : 0) | (c.out.last << 3) |
         (c.ld.lead << 5) | (c.out.t << 10);
}

__device__ inline Chunk unpack_info(int score, int info) {
  Chunk c;
  c.score = score;
  c.ld.first = info & 3;
  c.ld.has_match = (info & 4) != 0;
  c.out.last = (info >> 3) & 3;
  c.ld.lead = (info >> 5) & 31;
  c.out.t = (info >> 10) & 31;
  return c;
}

// a, then b, as one chunk.
__device__ inline Chunk join(const Chunk& a, const Chunk& b, const Points& p) {
  if (b.ld.first == kNone) return a;
  if (a.ld.first == kNone) return b;
  Chunk c;
  c.score = a.score + b.score;
  if (b.ld.first == kMatch && a.out.last == kMatch)
    c.score += p.match2 - p.match;
  if (b.ld.first == kSub && a.out.last == kSub)
    c.score += run_gain(a.out.t, b.ld.lead, p);
  c.ld.first = a.ld.first;
  c.ld.has_match = a.ld.has_match || b.ld.has_match;
  c.ld.lead = a.ld.has_match ? a.ld.lead : min(a.ld.lead + b.ld.lead, p.lim3);
  if (b.ld.has_match) {
    c.out = b.out;
  } else {
    c.out.last = kSub;
    c.out.t = min((a.out.last == kSub ? a.out.t : 0) + b.ld.lead, p.lim3);
  }
  return c;
}

__global__ void __launch_bounds__(32 * kWarps) gapless_warp_kernel(
    const uint8_t* __restrict__ rcodes, int B, int L, int K, int R,
    const int* __restrict__ mode, const int* __restrict__ strand, Genome g,
    Points pts, int* __restrict__ scores) {
  extern __shared__ uint2 words[];
  const int nwr = (L + 15) >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = warp / K;
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const long long b = b0 + r;
  // the block's reads staged, then the K warps of read r pack it
  unsigned* buf = reinterpret_cast<unsigned*>(words + R * 2 * nwr);
  const int o = stage_rows(rcodes, b0, static_cast<int>(min(
                               static_cast<long long>(R), B - b0)), L, buf);
  __syncthreads();
  uint2* mine = words + r * 2 * nwr;
  if (b < B) pack_read(buf, o + r * L, L, nwr, threadIdx.x - 32 * K * r,
                       32 * K, mine);
  __syncthreads();
  if (b >= B) return;                        // the whole warp
  const long long t = b * K + warp - r * K;
  const Window win = window_of(mode[t], L, g.G);
  const int cw = (nwr + 31) >> 5;
  const int w0 = min(lane * cw, nwr);
  Chunk c{0, {kNone, 0}, {kNone, 0, false}};
  c.score = score_words<true>(mine + (strand[t] != 0 ? nwr : 0), win, w0,
                                  min(w0 + cw, nwr), g, c.out, c.ld, pts);
  // lane i joins lanes [i, i + d) with [i + d, i + 2 d): chunks in order
  for (int d = 1; d < 32; d <<= 1) {
    const int os = __shfl_down_sync(kFull, c.score, d);
    const int oi = __shfl_down_sync(kFull, pack_info(c), d);
    if ((lane & (2 * d - 1)) == 0) c = join(c, unpack_info(os, oi), pts);
  }
  if (lane == 0) scores[t] = c.score;
}

}  // namespace

extern "C" {

// rcodes (B, L) uint8 codes (0..3, 4 = N), mode and strand (B, K) int32,
// row-major; gpack (nw,) and nmask (nwn,) uint32 words held in int64 (nmask
// read only when has_n); G the genome's length. mapping 0: a thread a
// candidate (K <= 256); 1: a warp a candidate (K <= 8). lim3 in 1..15.
// scores (B, K) int32.
cudaError_t gapless_score_launch(const uint8_t* rcodes, int B, int L, int K,
                                 const int* mode, const int* strand,
                                 const long long* gpack, long long nw,
                                 const long long* nmask, long long nwn,
                                 long long G, int has_n, int match,
                                 int match2, int sub, int sub2, int sub3,
                                 int lim3, int mapping, int* scores,
                                 cudaStream_t stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (L < 1 || (has_n && nwn < 1) || lim3 < 1 || lim3 > 15 ||
      (mapping != 0 && mapping != 1) || (mapping == 0 && K > kThreads) ||
      (mapping == 1 && K > kWarps) || nw < (G + 15) / 16)
    return cudaErrorInvalidValue;
  const Points pts{match, match2, sub, sub2, sub3, lim3};
  const Genome g{gpack, nmask, (G + 15) / 16, has_n ? nwn : 0, G, has_n};
  int R = mapping == 0 ? kThreads / K : kWarps / K;
  // the staged words' first and last may hold 3 bytes of other rows, and
  // one zero word follows them
  while (R > 1 && R * read_smem(L) + 16 > kSmemDefault) R = (R + 1) / 2;
  const size_t smem = R * read_smem(L) + 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const long long blocks = (static_cast<long long>(B) + R - 1) / R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto kernel = mapping == 0 ? gapless_thread_kernel
                                   : gapless_warp_kernel;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = mapping == 0 ? R * K : 32 * R * K;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      rcodes, B, L, K, R, mode, strand, g, pts, scores);
  return cudaGetLastError();
}

}  // extern "C"
