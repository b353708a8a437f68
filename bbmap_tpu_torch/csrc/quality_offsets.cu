// Quality-driven key offsets: keyProbs, the makeOffsets3 ladder, the
// Solver weights and the probAllErrors reject flag, one launch a batch.
//
// Replaces the JAX package's _quality_offsets_core
// (bbmap_tpu/align/quickmap_device.py:781, its key ladder a `for i in
// range(nk)` loop that jit unrolls into one XLA program, :840; reference:
// QualityTools.makeKeyProbs + KeyRing.makeOffsets3, AbstractMapThread
// .java:704-727). The port ran it as eager tensor steps: two k-step loops,
// ~30 launches a ladder step over (B, m) masks and an nk-step product,
// 1,188 dispatches a call at L = 150 (nk = 18) and 43,640 at L = 6,000
// (nk = 750).
//
// The function, per read (q phred 0..127, pc its probability correct, L
// bases, k the key length, m = L - k + 1 key positions, nk keys), all
// float32 and rounded step by step as the JAX package's operations are:
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
// Design: a block a read. The threads compute probs into shared memory and
// ok2 as a bitmask a warp word at a time (__ballot_sync), left / right by
// shared atomics and potential by __popc over the masked words; one thread
// runs the ladder, finding the backward candidate with __clz and the
// forward one with __ffs over the mask words; the threads then compute the
// weights, and one thread the reject product in order. Every product and
// sum is __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts none of them
// into an FMA (the JAX package's operations round each one), and the
// thresholds and constants come from the host as the float32 values the
// plain version uses.
//
// What bounds it: bytes at the main path's size (65,536 reads of 150:
// q and pc read once, 8 B a base, and the outputs; B x m x k multiplies are
// a few microseconds of the card's lanes), latency on the long path (32
// reads: 32 blocks, each an nk = 750-step ladder of one thread). Its gain
// is the launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90

__host__ __device__ inline size_t smem_bytes(int m, int nk) {
  // probs (m floats), ok2 ((m + 31) / 32 words), the offsets and psel
  // (nk each)
  return 4 * (static_cast<size_t>(m) + ((m + 31) >> 5) + 2 * nk);
}

// Bits of mask word w whose index lies in [lo, hi] (lo <= hi).
__device__ inline unsigned bits_in(int w, int lo, int hi) {
  const int a = max(lo - (w << 5), 0);
  const int b = min(hi - (w << 5), 31);
  if (a > b) return 0u;
  const unsigned upto = b == 31 ? 0xffffffffu : (1u << (b + 1)) - 1u;
  return upto & (0xffffffffu << a);
}

// The highest / lowest set index of the mask in [lo, hi], -1 if none.
__device__ int highest_in(const unsigned* words, int lo, int hi) {
  if (lo > hi) return -1;
  for (int w = hi >> 5; w >= (lo >> 5); --w) {
    const unsigned bits = words[w] & bits_in(w, lo, hi);
    if (bits) return (w << 5) + 31 - __clz(bits);
  }
  return -1;
}

__device__ int lowest_in(const unsigned* words, int lo, int hi) {
  if (lo > hi) return -1;
  for (int w = lo >> 5; w <= (hi >> 5); ++w) {
    const unsigned bits = words[w] & bits_in(w, lo, hi);
    if (bits) return (w << 5) + __ffs(bits) - 1;
  }
  return -1;
}

__global__ void quality_offsets_kernel(
    const int* __restrict__ q, const float* __restrict__ pc, int L, int k,
    int nk, const int* __restrict__ d2_tab, const float* __restrict__ div_tab,
    const int* __restrict__ ladder, float l1, float l2, int base_ks,
    float rng, float inv_a, int* __restrict__ out_off,
    float* __restrict__ wts, uint8_t* __restrict__ reject) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = L - k + 1;
  const int nw = (m + 31) >> 5;
  float* probs = reinterpret_cast<float*>(smem);
  unsigned* ok2 = reinterpret_cast<unsigned*>(probs + m);
  int* offs = reinterpret_cast<int*>(ok2 + nw);
  float* psel = reinterpret_cast<float*>(offs + nk);
  __shared__ int s_left, s_right, s_pot, s_valid;

  const long long b = blockIdx.x;
  const int* qb = q + b * L;
  const float* pb = pc + b * L;
  if (threadIdx.x == 0) {
    s_left = m;
    s_right = -1;
    s_pot = 0;
  }
  __syncthreads();
  int lmin = m, lmax = -1;
  // blockDim.x is a multiple of 32, so a warp's 32 positions are one mask
  // word
  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool in2 = false;
    if (i < m) {
      float prob = pb[i];
      bool zero = qb[i] == 0;
      for (int j = 1; j < k; ++j) {
        prob = __fmul_rn(prob, pb[i + j]);
        zero |= qb[i + j] == 0;
      }
      const float p = zero ? 1.0f : __fsub_rn(1.0f, prob);
      probs[i] = p;
      if (p < l1) {
        lmin = min(lmin, i);
        lmax = max(lmax, i);
      }
      in2 = p < l2;
    }
    const unsigned word = __ballot_sync(0xffffffffu, in2);
    if ((threadIdx.x & 31) == 0 && i < m) ok2[i >> 5] = word;
  }
  if (lmax >= 0) {
    atomicMin(&s_left, lmin);
    atomicMax(&s_right, lmax);
  }
  __syncthreads();
  const bool any1 = s_right >= 0;
  const int left = any1 ? s_left : 0;
  const int right = any1 ? s_right : m - 1;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    const unsigned bits = ok2[w] & bits_in(w, left, right);
    if (bits) atomicAdd(&s_pot, __popc(bits));
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int pot = s_pot;
    const bool valid = any1 && pot > 0 && right >= left;
    s_valid = valid;
    if (!valid) {
      for (int i = 0; i < nk; ++i) offs[i] = ladder[i];
    } else {
      const int usable = right - left + k;
      const int slots = usable - k + 1;
      int d2 = d2_tab[min(max(usable, 0), L)];
      d2 = min(slots, max(d2, 2));
      int desired = usable < L ? min(d2, nk) : nk;
      desired = max(min(desired, pot), 1);
      const int span = min(max(right - left, 0), m - 1);
      const int dm1 = min(max(desired - 1, 0), nk - 1);
      const float interval =
          div_tab[static_cast<long long>(span) * nk + dm1];
      const int interval_int = static_cast<int>(interval) + 1;
      float f = static_cast<float>(left);
      int prev = -1, j = left;
      for (int i = 0; i < nk; ++i) {
        if (i >= desired) {
          offs[i] = -1;   // inactive: the state stays
          continue;
        }
        int x = -1;
        if (prev < j) {
          if (probs[min(max(j, 0), m - 1)] < l2) {
            x = j;
          } else {
            x = highest_in(ok2, max(prev + 3, 0), min(j - 1, m - 1));
            if (x < 0) {
              const int lim = min(j + interval_int, right);
              x = lowest_in(ok2, max(j + 1, 0), min(lim - 1, m - 1));
            }
          }
        }
        offs[i] = x;
        prev = x > -1 ? x : max(prev, j - 2);
        f = __fadd_rn(f, interval);
        const int fl = static_cast<int>(floorf(__fadd_rn(f, 0.5f)));
        j = min(max(j + 1, fl), m - 1);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int off = offs[i];
    const float p = off > -1 ? probs[min(max(off, 0), m - 1)] : 1.0f;
    const float t = __fmul_rn(rng, __fsub_rn(1.0f, p));
    const int score = base_ks + static_cast<int>(floorf(__fadd_rn(t, 0.5f)));
    out_off[b * nk + i] = off;
    wts[b * nk + i] = __fmul_rn(static_cast<float>(score), inv_a);
    psel[i] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float pae = psel[0];
    for (int i = 1; i < nk; ++i) pae = __fmul_rn(pae, psel[i]);
    reject[b] = s_valid && pae > 0.5f ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Shared memory a block takes at (L, k, nk); the wrapper refuses reads
// past a block's 227 KB (m ~ 56,000 key positions).
long long quality_offsets_smem(int L, int k, int nk) {
  return static_cast<long long>(smem_bytes(L - k + 1, nk));
}

// B reads: q (B, L) int32, pc (B, L) float32, row-major; d2_tab (L + 1,)
// int32, div_tab (m, nk) float32, ladder (nk,) int32. out_off (B, nk)
// int32, wts (B, nk) float32, reject (B,) bool bytes.
cudaError_t quality_offsets_launch(const int* q, const float* pc, int B,
                                   int L, int k, int nk, const int* d2_tab,
                                   const float* div_tab, const int* ladder,
                                   float l1, float l2, int base_ks, float rng,
                                   float inv_a, int* out_off, float* wts,
                                   uint8_t* reject, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const int m = L - k + 1;
  if (k < 1 || m < 1 || nk < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, nk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quality_offsets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = m <= 128 ? 128 : 256;
  quality_offsets_kernel<<<B, threads, smem, stream>>>(
      q, pc, L, k, nk, d2_tab, div_tab, ladder, l1, l2, base_ks, rng, inv_a,
      out_off, wts, reject);
  return cudaGetLastError();
}

}  // extern "C"
