// Multi-state banded affine DP (MS / DEL / INS) for Hopper, score and fill.
//
// Replaces the Pallas TPU kernels msa_score_pallas_t and msa_fill_pallas_t
// (bbmap_tpu/ops/msa_pallas.py:577 and :588, kernel body _make_kernel_t
// at :313). Same cell semantics: packed ``score << SCOREOFFSET | streak``
// int32 cells, streak-dependent sub / ins / del tiers, barrier rows, N and
// gap-column handling, per-job row counts, a running last-row best per
// state and the first maximum in MS > DEL > INS order. The fill variant
// also emits one byte of packed prev-state codes (ms | del << 2 | ins << 4)
// per cell, job-major (B, R+C, R+1), for the traceback walk.
//
// Mapping: one block per job, thread r owns DP row r, and the block sweeps
// the R+C anti-diagonals in order. A thread keeps its own row's previous
// cell and its upper neighbour's wave d-2 cell in registers, so the only
// exchange is the upper neighbour's wave d-1 cell, read from one of two
// shared-memory wave slots (3 ints per row) and followed by one
// __syncthreads() per wave.
//
// What bounds it on this card: the sweep is serial in the waves. Every
// wave costs one barrier and about three ints read and three written per
// cell from shared memory, against roughly sixty integer operations; no
// work is shared between jobs, and device memory sees only the inputs,
// three ints out per job, and (fill) one byte per cell, written by
// neighbouring threads to neighbouring bytes. One block per job is the
// simple correct start: jobs are independent, a block of R+1 threads
// matches the wave width exactly, and tens of thousands of jobs keep all
// SMs busy without any cross-block scheduling. Packing several jobs per
// block or per warp, to cut the barrier cost, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Profile constants, all POINTSoff_* values already shifted by SCOREOFFSET.
// The order matches the int32 array built by ops/msa_kernels.py.
struct Prof {
  int TIMEMASK, SCOREOFFSET, MAX_TIME, MASK5, BARRIER_I1, BARRIER_D1;
  int L3, L4, L5;
  int MATCH, MATCH2, SUB, SUBR, SUB2, SUB3, NOCALL;
  int INS, INS2, INS3, INS4;
  int DEL, DEL2, DEL3, DEL4, DEL5, DEL_REF_N, GAP, BADoff;
};
constexpr int kProfInts = 28;
constexpr int NEG_INF = -2147483646;  // -(2**31) + 2

// int32 addition with two's-complement wrap (signed overflow is undefined
// in C++; the reference wraps like JAX int32).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int clamp_time(int t, const Prof& P) {
  return t > P.MAX_TIME ? P.MAX_TIME - P.MASK5 : t;
}

__device__ __forceinline__ int sub_array(int i, const Prof& P) {
  return i > P.L3 ? P.SUB3 : (i > 1 ? P.SUB2 : P.SUB);
}

__device__ __forceinline__ int ins_array(int i, const Prof& P) {
  return i > P.L4 ? P.INS4 : (i > P.L3 ? P.INS3 : (i > 1 ? P.INS2 : P.INS));
}

__device__ __forceinline__ int del_ext(int s, const Prof& P) {
  if (s == 0) return P.DEL;
  if (s < P.L3) return P.DEL2;
  if (s < P.L4) return P.DEL3;
  if (s < P.L5) return P.DEL4;
  return (s & P.MASK5) == 0 ? P.DEL5 : 0;
}

template <bool WANT_PREVS>
__global__ void msa_dp_kernel(const uint8_t* __restrict__ reads,
                              const uint8_t* __restrict__ refs,
                              const int* __restrict__ rows_in, int B, int R,
                              int C, Prof P, int* __restrict__ out,
                              uint8_t* __restrict__ prevs) {
  extern __shared__ int smem[];
  const int Rp1 = R + 1;
  int* wave = smem;  // [2 slots][3 states][R+1]
  uint8_t* ref_s = reinterpret_cast<uint8_t*>(smem + 6 * Rp1);
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const bool live = r <= R;
  const int rows = rows_in[b];
  const int SM = ~P.TIMEMASK;
  const int TM = P.TIMEMASK;
  const int BAD = P.BADoff;

  const uint8_t* ref_g = refs + static_cast<size_t>(b) * C;
  for (int i = r; i < C; i += blockDim.x) ref_s[i] = ref_g[i];
  const uint8_t* read_g = reads + static_cast<size_t>(b) * R;
  const int read1 = (live && r >= 1) ? read_g[r - 1] : '?';
  const int read0 = (live && r >= 2) ? read_g[r - 2] : '?';

  // column-0 boundary: cumulative insertion penalty of row r
  long long ins0_acc = 0;
  if (live) {
    for (int i = 1; i <= r; ++i) {
      const int off = i > P.L4 ? P.INS4
                    : (i > P.L3 ? P.INS3 : (i > 1 ? P.INS2 : P.INS));
      ins0_acc = (i < 2 ? 0 : ins0_acc) + off;
    }
  }
  const int ins0 = static_cast<int>(ins0_acc);
  const int maxGain = wadd(static_cast<int>(
      static_cast<uint32_t>(rows - 1) * static_cast<uint32_t>(P.MATCH2)), P.MATCH);
  const int subfloor = static_cast<int>(
      static_cast<uint32_t>(maxGain) * static_cast<uint32_t>(-2));

  // own row's cell on wave d-1, upper neighbour's cell on wave d-2
  int own_ms = r == 0 ? 0 : BAD, own_del = own_ms, own_ins = own_ms;
  int dd_ms = BAD, dd_del = BAD, dd_ins = BAD;
  int best0 = NEG_INF, best1 = NEG_INF, best2 = NEG_INF;
  int col0 = 0, col1 = 0, col2 = 0;
  if (live) {
    wave[r] = own_ms;
    wave[Rp1 + r] = own_del;
    wave[2 * Rp1 + r] = own_ins;
  }
  __syncthreads();

  const int n_waves = R + C;
  for (int d = 1; d <= n_waves; ++d) {
    if (live) {
      const int* rd = wave + ((d - 1) & 1) * 3 * Rp1;
      int up_ms = BAD, up_del = BAD, up_ins = BAD;
      if (r >= 1) {
        up_ms = rd[r - 1];
        up_del = rd[Rp1 + r - 1];
        up_ins = rd[2 * Rp1 + r - 1];
      }
      const int c = d - r;
      const int ref1 = (c >= 1 && c <= C) ? ref_s[c - 1] : '!';
      const int ref0 = (c >= 2 && c <= C + 1) ? ref_s[c - 2] : '!';
      const bool match = read1 == ref1 && ref1 != 'N';
      const bool pm = read0 == ref0 && ref0 != 'N';
      const bool gap = ref1 == '-';

      // ---- MS (diagonal predecessors: wave d-2, row r-1)
      const int s_diag = dd_ms & SM, s_del = dd_del & SM, s_ins = dd_ins & SM;
      const int streak = dd_ms & TM;
      const int m_ms = wadd(s_diag, pm ? P.MATCH2 : P.MATCH);
      const int m_d = wadd(s_del, P.MATCH);
      const int m_i = wadd(s_ins, P.MATCH);
      const int m_best = max(m_ms, max(m_d, m_i));
      const bool m_from_ms = m_ms >= m_d && m_ms >= m_i;
      const int m_time = (m_from_ms && pm) ? streak + 1 : 1;
      const int sub_pen = pm ? (streak <= 1 ? P.SUBR : P.SUB)
                             : sub_array(streak + 1, P);
      const int x_ms = (ref1 != 'N' && read1 != 'N') ? wadd(s_diag, sub_pen)
                                                     : wadd(s_diag, P.NOCALL);
      const int x_d = wadd(s_del, P.SUB);
      const int x_i = wadd(s_ins, P.SUB);
      const int x_best = max(x_ms, max(x_d, x_i));
      const bool x_from_ms = x_ms >= x_d && x_ms >= x_i;
      const int x_time = x_from_ms ? (pm ? 1 : streak + 1) : 1;
      const int ms_score = match ? m_best : x_best;
      const int ms_time = clamp_time(match ? m_time : x_time, P);
      int ms_val = gap ? subfloor : (ms_score | ms_time);

      // ---- DEL (left: own row, wave d-1)
      const int dstreak = own_del & TM;
      const int refn_adj = ref1 == 'N' ? P.DEL_REF_N : (gap ? P.GAP : 0);
      const int d_ms = wadd(wadd(own_ms & SM, P.DEL), refn_adj);
      const int d_d = wadd(wadd(own_del & SM, del_ext(dstreak, P)), refn_adj);
      const int del_score = max(d_ms, d_d);
      const int del_time = clamp_time(d_ms >= d_d ? 1 : dstreak + 1, P);
      const bool del_barrier = r < P.BARRIER_D1 || r > rows - P.BARRIER_D1;
      int del_val = del_barrier ? subfloor : (del_score | del_time);

      // ---- INS (up: row r-1, wave d-1)
      const int istreak = up_ins & TM;
      const int i_ms = wadd(up_ms & SM, P.INS);
      const int i_i = wadd(up_ins & SM, ins_array(istreak + 1, P));
      const int ins_score = max(i_ms, i_i);
      const int ins_time = clamp_time(i_ms >= i_i ? 1 : istreak + 1, P);
      const bool ins_barrier = gap || (r < P.BARRIER_I1 && c > 1) ||
                               (r > rows - P.BARRIER_I1 && c < C - 1);
      int ins_val = ins_barrier ? subfloor : (ins_score | ins_time);

      // boundaries: row 0 is free (0), column 0 carries ins0; cells off
      // the window or below the job's last row are BAD
      if (r == 0) {
        ms_val = del_val = ins_val = 0;
      } else if (c == 0) {
        ms_val = del_val = ins_val = ins0;
      }
      if (c < 0 || c > C || r > rows) ms_val = del_val = ins_val = BAD;

      if (WANT_PREVS) {
        const int ms_arg = (s_diag >= s_del && s_diag >= s_ins)
                               ? 0 : (s_del >= s_ins ? 1 : 2);
        const int ms_prev = ms_time > 1 ? 0 : ms_arg;
        const int del_prev = del_time > 1 ? 1
                           : ((own_ms & SM) >= (own_del & SM) ? 0 : 1);
        const int ins_prev = ins_time > 1 ? 2
                           : ((up_ms & SM) >= (up_ins & SM) ? 0 : 2);
        prevs[(static_cast<size_t>(b) * n_waves + (d - 1)) * Rp1 + r] =
            static_cast<uint8_t>(ms_prev | (del_prev << 2) | (ins_prev << 4));
      }

      if (r == rows && c >= 1 && c <= C) {
        const int v0 = ms_val & SM, v1 = del_val & SM, v2 = ins_val & SM;
        if (v0 > best0) { best0 = v0; col0 = c; }
        if (v1 > best1) { best1 = v1; col1 = c; }
        if (v2 > best2) { best2 = v2; col2 = c; }
      }

      int* wr = wave + (d & 1) * 3 * Rp1;
      wr[r] = ms_val;
      wr[Rp1 + r] = del_val;
      wr[2 * Rp1 + r] = ins_val;
      dd_ms = up_ms;
      dd_del = up_del;
      dd_ins = up_ins;
      own_ms = ms_val;
      own_del = del_val;
      own_ins = ins_val;
    }
    __syncthreads();
  }

  if (live && r == rows) {
    int state, score, col;
    if (best0 >= best1 && best0 >= best2) {
      state = 0; score = best0; col = col0;
    } else if (best1 >= best2) {
      state = 1; score = best1; col = col1;
    } else {
      state = 2; score = best2; col = col2;
    }
    out[b] = score >> P.SCOREOFFSET;
    out[B + b] = col;
    out[2 * B + b] = state;
  }
}

template <bool WANT_PREVS>
cudaError_t launch(const uint8_t* reads, const uint8_t* refs, const int* rows,
                   int B, int R, int C, const int* prof, int* out,
                   uint8_t* prevs, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  Prof P;
  static_assert(sizeof(Prof) == kProfInts * sizeof(int), "Prof layout");
  int* pp = reinterpret_cast<int*>(&P);
  for (int i = 0; i < kProfInts; ++i) pp[i] = prof[i];
  const int threads = ((R + 1 + 31) / 32) * 32;
  const size_t smem = 6 * static_cast<size_t>(R + 1) * sizeof(int) + C;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        msa_dp_kernel<WANT_PREVS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  msa_dp_kernel<WANT_PREVS><<<B, threads, smem, stream>>>(
      reads, refs, rows, B, R, C, P, out, prevs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// reads (B, R) uint8, refs (B, C) uint8, rows (B,) int32, prof: host
// int32[28]; out (3, B) int32 = [score >> SCOREOFFSET, col, state].
cudaError_t msa_score_launch(const uint8_t* reads, const uint8_t* refs,
                             const int* rows, int B, int R, int C,
                             const int* prof, int* out, cudaStream_t stream) {
  return launch<false>(reads, refs, rows, B, R, C, prof, out, nullptr, stream);
}

// As msa_score_launch, plus prevs (B, R+C, R+1) uint8 prev-state codes.
cudaError_t msa_fill_launch(const uint8_t* reads, const uint8_t* refs,
                            const int* rows, int B, int R, int C,
                            const int* prof, int* out, uint8_t* prevs,
                            cudaStream_t stream) {
  return launch<true>(reads, refs, rows, B, R, C, prof, out, prevs, stream);
}

}  // extern "C"
