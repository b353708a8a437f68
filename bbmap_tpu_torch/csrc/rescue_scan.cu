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
// Design (the simple kernel first): a block a job. The block stages the
// read (an N as 5) and the window (a bad base as 4, read from the 2-bit
// packed genome and its N mask as DeviceIndex holds them: uint32 words in
// int64, 16 bases and 32 flags a word), so a compare is one byte equality,
// in shared memory; its threads stride over the offsets and keep mism and
// score in shared memory; then one thread walks. The walk is order
// dependent (each step reads the klim and min_mm of the one before), so it
// stays one chain; it stops at k = min(n, N_OFF) (no later t lies in
// [0, n)) or once k passes klim (klim never grows): the steps it skips
// accept nothing, so the result is the same. Only the offsets the walk can
// read, t < min(n, N_OFF), are scanned, and only the window bytes they
// cover are staged.
//
// What bounds it: at the main path's sizes, latency. A job is n x Lm
// compares (n <= 1,536, Lm = 150: at most 230,400, a few microseconds of
// one SM) and a walk of at most N_OFF dependent steps; a batch holds
// hundreds to a few thousand jobs. Its gain is the launches: one where the
// eager loops made tens of thousands.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90
constexpr int kBigA = 1 << 30;

__host__ __device__ inline size_t smem_bytes(int Lm, int N_OFF) {
  // mism and score (int32 a offset), then the window and the read
  const size_t bytes = 8 * static_cast<size_t>(N_OFF) + N_OFF + 2 * Lm;
  return (bytes + 15) & ~static_cast<size_t>(15);
}

__global__ void __launch_bounds__(kThreads) rescue_scan_kernel(
    const long long* __restrict__ gpack, const long long* __restrict__ nmask,
    long long G, int has_n, const uint8_t* __restrict__ reads,
    const int* __restrict__ lo, const int* __restrict__ nn,
    const int* __restrict__ ideal_k, const uint8_t* __restrict__ right,
    const int* __restrict__ max_mm, int Lm, int N_OFF,
    int* __restrict__ best_k_out, int* __restrict__ min_mm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* mism = reinterpret_cast<int*>(smem);
  int* score = mism + N_OFF;
  uint8_t* win = reinterpret_cast<uint8_t*>(score + N_OFF);
  uint8_t* rd = win + N_OFF + Lm;

  const int job = blockIdx.x;
  const int n = nn[job];
  // offsets the walk reads: t in [0, n) clamped to N_OFF - 1
  const int used = max(0, min(n, N_OFF));
  const int staged = used ? used + Lm - 1 : 0;
  const long long base = lo[job];
  for (int p = threadIdx.x; p < staged; p += blockDim.x) {
    const long long pos = base + p;
    uint8_t c = 4;
    if (pos >= 0 && pos < G) {
      const unsigned w = static_cast<unsigned>(gpack[pos >> 4]);
      c = static_cast<uint8_t>((w >> ((pos & 15) * 2)) & 3u);
      if (has_n &&
          ((static_cast<unsigned>(nmask[pos >> 5]) >> (pos & 31)) & 1u))
        c = 4;
    }
    win[p] = c;
  }
  const uint8_t* rj = reads + static_cast<long long>(job) * Lm;
  for (int j = threadIdx.x; j < Lm; j += blockDim.x) {
    const uint8_t c = rj[j];
    rd[j] = c > 3 ? 5 : c;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < used; t += blockDim.x) {
    int mm = 0, cur = 0, best = 0;
    for (int j = 0; j < Lm; ++j) {
      const bool good = win[t + j] == rd[j];
      mm += good ? 0 : 1;
      cur = good ? cur + 1 : 0;
      best = max(best, cur);
    }
    mism[t] = mm;
    score[t] = (Lm - mm) + best;
  }
  __syncthreads();

  if (threadIdx.x != 0) return;
  const bool rt = right[job] != 0;
  const int ik = ideal_k[job];
  const int kref = rt ? ik : (n - 1) - ik;
  int min_mm = max_mm[job] + 1, best_s = 0, best_a = kBigA, best_k = -1;
  int klim = N_OFF;
  for (int k = 0; k < used && k <= klim; ++k) {
    const int t = rt ? k : (n - 1) - k;
    const int ts = min(t, N_OFF - 1);
    const int m = mism[ts], s = score[ts];
    const int a = abs(t - ik);
    if (m <= min_mm && (s > best_s || (s == best_s && a < best_a))) {
      min_mm = m;
      best_s = s;
      best_a = a;
      best_k = k;
      if (m == 0) klim = min(klim, kref + a);
    }
  }
  best_k_out[job] = best_k;
  min_mm_out[job] = min_mm;
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
  if (Lm < 1 || N_OFF < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Lm, N_OFF);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rescue_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rescue_scan_kernel<<<R, kThreads, smem, stream>>>(
      gpack, nmask, G, has_n, reads, lo, n, ideal_k, right, max_mm, Lm,
      N_OFF, best_k, min_mm);
  return cudaGetLastError();
}

}  // extern "C"
