// The candidate table's gapless streak score: each (read, candidate) scored
// at its modal diagonal against the 2-bit packed genome, one launch a
// batch, with no (B, K, L) tensor.
//
// Replaces the scoring half of the JAX package's finalize_stage
// (bbmap_tpu/align/quickmap_device.py:1291, its extract_ref_codes at :244
// and gapless.score_match_sub_vec, fused by XLA into one program;
// reference: MultiStateAligner11ts.scoreNoIndels:1885-1952). The port ran
// it as eager tensor steps over (B, K, L) = (65,536, 8, 150), 78.6 M
// elements: the reference extraction (int64 positions, word and N-mask
// gathers), the strand flip, eq / is_match / is_sub, and the closed form's
// 3 cummax and 1 cumsum with ~20 elementwise ops.
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
// Design: a thread a (read, candidate); the K threads of a read are
// neighbours, so a read's code is one broadcast load for them. The thread
// walks its window a genome word at a time (16 bases: the 2-bit word and
// the word's 16 bits of the N mask), loading the next word's pair while it
// scores the current one, and the 16 positions of a word unrolled, so
// their read-code loads wait on nothing the run state computes and go out
// together; the first and last words score only the positions inside the
// window.
//
// What bounds it: bytes (the read codes, the candidates' modes and
// strands, the genome words under each window and the scores: ~62 MB at
// 65,536 x 8 x 150); on the long path (32 reads of 6,000, K = 8) the
// sequential walk of 256 threads. Its gain is ~30 launches over 78.6 M
// elements each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Points {
  int match, match2, sub, sub2, sub3, lim3;
};

// The 2-bit word of genome positions [16 w, 16 w + 16) (0 past either
// end: those positions are out of range, so N), and its 16 N-mask bits.
__device__ inline unsigned genome_word(const long long* gpack, long long nw,
                                       long long w, long long G) {
  if (w < 0 || (w << 4) >= G) return 0u;
  return static_cast<unsigned>(gpack[min(w, nw - 1)]);
}

__device__ inline unsigned n_bits(const long long* nmask, long long nwn,
                                  long long w, long long G, int has_n) {
  if (!has_n || w < 0 || (w << 4) >= G) return 0u;
  const unsigned word = static_cast<unsigned>(nmask[min(w >> 1, nwn - 1)]);
  return (word >> ((w & 1) * 16)) & 0xffffu;
}

__global__ void gapless_score_kernel(
    const uint8_t* __restrict__ rcodes, int B, int L, int K,
    const int* __restrict__ mode, const int* __restrict__ strand,
    const long long* __restrict__ gpack, long long nw,
    const long long* __restrict__ nmask, long long nwn, long long G,
    int has_n, Points pts, int* __restrict__ scores) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * K) return;
  const uint8_t* read = rcodes + (t / K) * L;
  const long long base = mode[t];
  const bool minus = strand[t] != 0;
  int score = 0;
  int run = 0;          // 0 none, 1 matches, 2 subs
  int streak = 0;       // positions of the run after its first
  const long long w_last = (base + L - 1) >> 4;
  long long w = base >> 4;
  unsigned next_word = genome_word(gpack, nw, w, G);
  unsigned next_n = n_bits(nmask, nwn, w, G, has_n);
  for (; w <= w_last; ++w) {
    const unsigned word = next_word, nb = next_n;
    if (w < w_last) {
      next_word = genome_word(gpack, nw, w + 1, G);
      next_n = n_bits(nmask, nwn, w + 1, G, has_n);
    }
    const long long p0 = w << 4;
    const int j0 = static_cast<int>(p0 - base);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int j = j0 + q;
      if (j < 0 || j >= L) continue;
      int c = minus ? read[L - 1 - j] : read[j];
      if (minus && c <= 3) c = 3 - c;
      const long long pos = p0 + q;
      const bool ref_n = pos < 0 || pos >= G || ((nb >> q) & 1u);
      const int r = (word >> (2 * q)) & 3;
      const bool read_n = c > 3;
      const bool eq = c == r && !ref_n;
      if (eq && !read_n) {
        score += run == 1 ? pts.match2 : pts.match;
        streak = run == 1 ? streak + 1 : 0;
        run = 1;
      } else if (!eq && !read_n && !ref_n) {
        const int s = run == 2 ? streak + 1 : 0;
        score += s + 1 > pts.lim3 ? pts.sub3
                                  : (s + 1 > 1 ? pts.sub2 : pts.sub);
        streak = s;
        run = 2;
      }
    }
  }
  scores[t] = score;
}

}  // namespace

extern "C" {

// rcodes (B, L) uint8 codes (0..3, 4 = N), mode and strand (B, K) int32,
// row-major; gpack (nw,) and nmask (nwn,) uint32 words held in int64 (nmask
// read only when has_n); G the genome's length. scores (B, K) int32.
cudaError_t gapless_score_launch(const uint8_t* rcodes, int B, int L, int K,
                                 const int* mode, const int* strand,
                                 const long long* gpack, long long nw,
                                 const long long* nmask, long long nwn,
                                 long long G, int has_n, int match,
                                 int match2, int sub, int sub2, int sub3,
                                 int lim3, int* scores, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * K;
  if (n <= 0) return cudaSuccess;
  if (L < 1 || nw < 1 || (has_n && nwn < 1)) return cudaErrorInvalidValue;
  const Points pts{match, match2, sub, sub2, sub3, lim3};
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gapless_score_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      rcodes, B, L, K, mode, strand, gpack, nw, nmask, nwn, G, has_n, pts,
      scores);
  return cudaGetLastError();
}

}  // extern "C"
