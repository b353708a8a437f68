// Shared device code of the DP kernels: the scoring profile, the two
// operand readers, one DP cell (dp_cell), and the last-row best. Included
// by msa_dp.cu (one row per thread; rows strided over the block) and
// msa_dp_warp.cu (a warp a job), so every mapping evaluates the same cell.

#pragma once

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
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block on sm_90

// The profile from the host int32[28] the wrapper passes.
inline Prof load_prof(const int* prof) {
  Prof P;
  static_assert(sizeof(Prof) == kProfInts * sizeof(int), "Prof layout");
  int* pp = reinterpret_cast<int*>(&P);
  for (int i = 0; i < kProfInts; ++i) pp[i] = prof[i];
  return P;
}

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

// Raw ASCII operands: reads (B, R) uint8, windows (B, C) uint8, out (3, B).
struct RawOps {
  const uint8_t* reads;
  const uint8_t* refs;
  static constexpr bool kJobMajorOut = false;

  struct Job {
    const uint8_t* read;  // the job's read (device or shared memory)
    const uint8_t* ref;   // the job's window, staged in shared memory
    int C;
    __device__ int read1(int r) const { return r >= 1 ? read[r - 1] : '?'; }
    __device__ int read0(int r) const { return r >= 2 ? read[r - 2] : '?'; }
    __device__ int ref1(int, int, int c) const {
      return (c >= 1 && c <= C) ? ref[c - 1] : '!';
    }
    __device__ int ref0(int, int, int c) const {
      return (c >= 2 && c <= C + 1) ? ref[c - 2] : '!';
    }
  };

  // Stages the window (C bytes) and, with stage_read, the read (R more
  // bytes) into shared memory at s. The caller synchronises.
  __device__ Job job(int b, int R, int C, uint8_t* s, bool stage_read,
                     int tid, int nt) const {
    const uint8_t* rf = refs + static_cast<size_t>(b) * C;
    for (int i = tid; i < C; i += nt) s[i] = rf[i];
    const uint8_t* rd = reads + static_cast<size_t>(b) * R;
    if (stage_read) {
      for (int i = tid; i < R; i += nt) s[C + i] = rd[i];
      rd = s + C;
    }
    return Job{rd, s, C};
  }

  // The job's operands where they lie in device memory, nothing staged.
  __device__ Job direct(int b, int R, int C) const {
    return Job{reads + static_cast<size_t>(b) * R,
               refs + static_cast<size_t>(b) * C, C};
  }
};

// msa_score_pallas's operands, read in place: read1 / read0 (B, R+1)
// int32, refpad (B, W = C+2R+2) int32 pre-rotated by -(C+R), out (B, 3).
struct RowOps {
  const int* read1;
  const int* read0;
  const int* refpad;
  static constexpr bool kJobMajorOut = true;

  struct Job {
    const int* r1;
    const int* r0;
    const int* rp;
    int W;
    __device__ int read1(int r) const { return r1[r]; }
    __device__ int read0(int r) const { return r0[r]; }
    // (r - d + 1) lies in (-W, W): one conditional add is the modulo
    __device__ int ref1(int r, int d, int) const {
      const int i = r - d + 1;
      return rp[i < 0 ? i + W : i];
    }
    __device__ int ref0(int r, int d, int) const {
      const int i = r - d + 2;
      return rp[i < 0 ? i + W : i];
    }
  };

  __device__ Job job(int b, int R, int C, uint8_t*, bool, int, int) const {
    const int W = C + 2 * R + 2;
    const size_t rb = static_cast<size_t>(b) * (R + 1);
    return Job{read1 + rb, read0 + rb, refpad + static_cast<size_t>(b) * W,
               W};
  }

  __device__ Job direct(int b, int R, int C) const {
    return job(b, R, C, nullptr, false, 0, 0);
  }
};

// One DP cell (r, c) on wave d from its neighbours: dd = (r-1, c-1) on
// wave d-2, own = (r, c-1) and up = (r-1, c) on wave d-1. ins0 is the
// column-0 boundary of row r. Writes the new MS / DEL / INS cells and,
// with WANT_PREVS, the packed prev-state code.
template <bool WANT_PREVS>
__device__ __forceinline__ void dp_cell(
    int r, int c, int C, int rows, int read1, int read0, int ref1, int ref0,
    int dd_ms, int dd_del, int dd_ins, int own_ms, int own_del, int up_ms,
    int up_ins, int ins0, int subfloor, const Prof& P, int& ms_out,
    int& del_out, int& ins_out, uint8_t& code) {
  const int SM = ~P.TIMEMASK;
  const int TM = P.TIMEMASK;
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
  if (c < 0 || c > C || r > rows) ms_val = del_val = ins_val = P.BADoff;

  if (WANT_PREVS) {
    const int ms_arg = (s_diag >= s_del && s_diag >= s_ins)
                           ? 0 : (s_del >= s_ins ? 1 : 2);
    const int ms_prev = ms_time > 1 ? 0 : ms_arg;
    const int del_prev = del_time > 1 ? 1
                       : ((own_ms & SM) >= (own_del & SM) ? 0 : 1);
    const int ins_prev = ins_time > 1 ? 2
                       : ((up_ms & SM) >= (up_ins & SM) ? 0 : 2);
    code = static_cast<uint8_t>(ms_prev | (del_prev << 2) | (ins_prev << 4));
  }
  ms_out = ms_val;
  del_out = del_val;
  ins_out = ins_val;
}

__device__ __forceinline__ int max_gain(int rows, const Prof& P) {
  return wadd(static_cast<int>(static_cast<uint32_t>(rows - 1) *
                               static_cast<uint32_t>(P.MATCH2)), P.MATCH);
}

__device__ __forceinline__ int sub_floor(int gain) {
  return static_cast<int>(static_cast<uint32_t>(gain) *
                          static_cast<uint32_t>(-2));
}

// Last-row best of one state: strictly greater keeps the first column.
__device__ __forceinline__ void track(int v, int c, int& best, int& col) {
  if (v > best) { best = v; col = c; }
}

template <class Ops>
__device__ __forceinline__ void store_out(int* out, int B, int b, int best0,
                                          int best1, int best2, int col0,
                                          int col1, int col2, const Prof& P) {
  int state, score, col;
  if (best0 >= best1 && best0 >= best2) {
    state = 0; score = best0; col = col0;
  } else if (best1 >= best2) {
    state = 1; score = best1; col = col1;
  } else {
    state = 2; score = best2; col = col2;
  }
  if (Ops::kJobMajorOut) {
    out[3 * b] = score >> P.SCOREOFFSET;
    out[3 * b + 1] = col;
    out[3 * b + 2] = state;
  } else {
    out[b] = score >> P.SCOREOFFSET;
    out[B + b] = col;
    out[2 * B + b] = state;
  }
}

}  // namespace
