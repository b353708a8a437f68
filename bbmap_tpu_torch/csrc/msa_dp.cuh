// Shared device code of the DP kernels: the scoring profile, the two
// operand readers, one DP cell (dp_cell), the last-row best, and one job's
// traceback walk (walk_job). Included by msa_dp.cu (one row per thread;
// rows strided over the block), msa_dp_warp.cu (a warp a job),
// msa_dp_band.cu (a warp a band of rows), msa_walk.cu (the walk over a
// block of prev codes in device memory, staged tile by tile in shared
// memory) and msa_fill_walk.cu (fill and walk of short jobs, the codes in
// shared memory), so every mapping evaluates the same cell and every walk
// takes the same steps (walk_step).

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

// dp_cell's DPX form: Hopper's DPX instructions in place of the plain max
// / compare chains. __viaddmax_s32 (max(a + b, c) in one instruction) for
// the MS sums that are only maximised, with equality to the maximum giving
// "came from MS"; __vibmax_s32 where its predicate a >= b gives the DEL /
// INS source and the MS prev code. Both forms give the same bits.
// msa_dp_pipe.cu turns it on; a build may turn it on for every mapping
// with -DBBMAP_DPX_DEFAULT=1 (chip_smoke.py times the other mappings so).
#ifndef BBMAP_DPX_DEFAULT
#define BBMAP_DPX_DEFAULT 0
#endif
constexpr bool kDpxDefault = BBMAP_DPX_DEFAULT != 0;

// max(a + b, c) with a + b wrapped as wadd, in the form DPX asks for.
template <bool DPX>
__device__ __forceinline__ int addmax(int a, int b, int c) {
  if (DPX) return __viaddmax_s32(a, b, c);
  return max(static_cast<int>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b)), c);
}

// One DP cell (r, c) on wave d from its neighbours: dd = (r-1, c-1) on
// wave d-2, own = (r, c-1) and up = (r-1, c) on wave d-1. ins0 is the
// column-0 boundary of row r. Writes the new MS / DEL / INS cells and,
// with WANT_PREVS, the packed prev-state code. DPX: the DPX form (above),
// the same bits.
template <bool WANT_PREVS, bool DPX = kDpxDefault>
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
  const int sub_pen = pm ? (streak <= 1 ? P.SUBR : P.SUB)
                         : sub_array(streak + 1, P);
  const int x_ms = (ref1 != 'N' && read1 != 'N') ? wadd(s_diag, sub_pen)
                                                 : wadd(s_diag, P.NOCALL);
  int m_best, x_best;
  bool m_from_ms, x_from_ms;
  if (DPX) {
    // "came from MS" is "MS is the maximum"
    m_best = addmax<DPX>(s_ins, P.MATCH, addmax<DPX>(s_del, P.MATCH, m_ms));
    x_best = addmax<DPX>(s_ins, P.SUB, addmax<DPX>(s_del, P.SUB, x_ms));
    m_from_ms = m_best == m_ms;
    x_from_ms = x_best == x_ms;
  } else {
    const int m_d = wadd(s_del, P.MATCH);
    const int m_i = wadd(s_ins, P.MATCH);
    m_best = max(m_ms, max(m_d, m_i));
    m_from_ms = m_ms >= m_d && m_ms >= m_i;
    const int x_d = wadd(s_del, P.SUB);
    const int x_i = wadd(s_ins, P.SUB);
    x_best = max(x_ms, max(x_d, x_i));
    x_from_ms = x_ms >= x_d && x_ms >= x_i;
  }
  const int m_time = (m_from_ms && pm) ? streak + 1 : 1;
  const int x_time = x_from_ms ? (pm ? 1 : streak + 1) : 1;
  const int ms_score = match ? m_best : x_best;
  const int ms_time = clamp_time(match ? m_time : x_time, P);
  int ms_val = gap ? subfloor : (ms_score | ms_time);

  // ---- DEL (left: own row, wave d-1)
  const int dstreak = own_del & TM;
  const int refn_adj = ref1 == 'N' ? P.DEL_REF_N : (gap ? P.GAP : 0);
  const int d_ms = wadd(wadd(own_ms & SM, P.DEL), refn_adj);
  const int d_d = wadd(wadd(own_del & SM, del_ext(dstreak, P)), refn_adj);
  bool d_from_ms;
  int del_score;
  if (DPX) {
    del_score = __vibmax_s32(d_ms, d_d, &d_from_ms);
  } else {
    del_score = max(d_ms, d_d);
    d_from_ms = d_ms >= d_d;
  }
  const int del_time = clamp_time(d_from_ms ? 1 : dstreak + 1, P);
  const bool del_barrier = r < P.BARRIER_D1 || r > rows - P.BARRIER_D1;
  int del_val = del_barrier ? subfloor : (del_score | del_time);

  // ---- INS (up: row r-1, wave d-1)
  const int istreak = up_ins & TM;
  const int i_ms = wadd(up_ms & SM, P.INS);
  const int i_i = wadd(up_ins & SM, ins_array(istreak + 1, P));
  bool i_from_ms;
  int ins_score;
  if (DPX) {
    ins_score = __vibmax_s32(i_ms, i_i, &i_from_ms);
  } else {
    ins_score = max(i_ms, i_i);
    i_from_ms = i_ms >= i_i;
  }
  const int ins_time = clamp_time(i_from_ms ? 1 : istreak + 1, P);
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
    int ms_arg;
    if (DPX) {
      // s_del >= s_ins, then s_diag >= both, from the predicates
      bool del_ge, diag_ge;
      __vibmax_s32(s_diag, __vibmax_s32(s_del, s_ins, &del_ge), &diag_ge);
      ms_arg = diag_ge ? 0 : (del_ge ? 1 : 2);
    } else {
      ms_arg = (s_diag >= s_del && s_diag >= s_ins)
                   ? 0 : (s_del >= s_ins ? 1 : 2);
    }
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

// The first maximum of the three last-row bests in MS > DEL > INS order.
__device__ __forceinline__ void pick_best(int best0, int best1, int best2,
                                          int col0, int col1, int col2,
                                          int& state, int& score, int& col) {
  if (best0 >= best1 && best0 >= best2) {
    state = 0; score = best0; col = col0;
  } else if (best1 >= best2) {
    state = 1; score = best1; col = col1;
  } else {
    state = 2; score = best2; col = col2;
  }
}

template <class Ops>
__device__ __forceinline__ void store_out(int* out, int B, int b, int best0,
                                          int best1, int best2, int col0,
                                          int col1, int col2, const Prof& P) {
  int state, score, col;
  pick_best(best0, best1, best2, col0, col1, col2, state, score, col);
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

// ---- the traceback walk
//
// Replaces the device walk of the JAX package, _walk_device
// (bbmap_tpu/ops/msa_jax.py:451). One job: start at row R, column col,
// state st; a step at (row, col) with row > 0 and col > 0 reads the code of
// cell (row, min(col, C)), emits m / S / N (state MS), D or - (DEL) or I or
// Y (INS), counts the '-' symbols, moves to the predecessor and takes its
// state from the code; with col <= 0 it emits X and moves up and left. The
// walk stops at row 0 or after `steps` symbols (row > 0 at the end marks a
// walk that was cut). Symbols go to sym_row in walk order (the reverse of
// the match string); the caller zeroes the rest of the row.
constexpr int MODE_MS = 0, MODE_DEL = 1, MODE_INS = 2;

__device__ __forceinline__ bool defined_base(int c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == 'U';
}

struct WalkEnd {
  int n;      // symbols written
  int gaps;   // '-' among them
  int row;    // the row the walk ended on
};

// The symbol of a step from (row, col), col > 0, in state st: c_ is the
// read's character row - 1, r_ the window's min(col, C) - 1. MS moves up
// and left, DEL left, INS up; a DEL step on a '-' column is a gap.
__device__ __forceinline__ int walk_symbol(int st, int c_, int r_, int col,
                                           int C) {
  if (st == MODE_MS)
    return c_ == r_ ? 'm' : (defined_base(c_) && defined_base(r_) ? 'S' : 'N');
  if (st == MODE_DEL) return r_ == '-' ? '-' : 'D';
  return col >= C ? 'Y' : 'I';
}

// One step from (row, col), col > 0, in state st, code the prev-code byte
// of cell (row, min(col, C)): the symbol, the move, the predecessor's
// state from the code, and the gap count.
__device__ __forceinline__ int walk_step(int code, int c_, int r_, int C,
                                         int& row, int& col, int& st,
                                         int& gaps) {
  const int sym = walk_symbol(st, c_, r_, col, C);
  gaps += st == MODE_DEL && r_ == '-';
  row -= st != MODE_DEL;
  col -= st != MODE_INS;
  st = (code >> (2 * st)) & 3;
  return sym;
}

// code(row, col) is the prev-code byte of cell (row, col), 1 <= row <= R,
// 1 <= col <= C, wherever the caller keeps it.
template <class CodeAt>
__device__ __forceinline__ WalkEnd walk_job(const CodeAt& code,
                                            const uint8_t* read,
                                            const uint8_t* ref, int R, int C,
                                            int col, int st, int steps,
                                            uint8_t* sym_row) {
  int row = R, gaps = 0, n = 0;
  for (; n < steps && row > 0; ++n) {
    int sym;
    if (col > 0) {
      const int cc = min(col, C);
      sym = walk_step(code(row, cc), read[row - 1], ref[cc - 1], C, row, col,
                      st, gaps);
    } else {
      sym = 'X';
      --row;
      --col;
    }
    sym_row[n] = static_cast<uint8_t>(sym);
  }
  return WalkEnd{n, gaps, row};
}

// Dynamic shared memory above 48 KB must be asked for before the launch.
template <class K>
cudaError_t raise_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
