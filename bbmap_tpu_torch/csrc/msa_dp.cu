// Multi-state banded affine DP (MS / DEL / INS) for Hopper, score and fill.
//
// Replaces the Pallas TPU kernels msa_score_pallas_t and msa_fill_pallas_t
// (bbmap_tpu/ops/msa_pallas.py:577 and :588, kernel body _make_kernel_t
// at :313) and msa_score_pallas (:243, kernel _make_kernel at :92). Same
// cell semantics: packed ``score << SCOREOFFSET | streak`` int32 cells,
// streak-dependent sub / ins / del tiers, barrier rows, N and gap-column
// handling, per-job row counts, a running last-row best per state and the
// first maximum in MS > DEL > INS order. The fill variant also emits one
// byte of packed prev-state codes (ms | del << 2 | ins << 4) per cell,
// job-major (B, R+C, R+1), for the traceback walk.
//
// Operands. Two readers feed the same kernels: RawOps takes raw ASCII
// reads (B, R) and windows (B, C) (msa_score_pallas_t / msa_fill_pallas_t
// callers); RowOps reads msa_score_pallas's operands as they are: read1 /
// read0 (B, R+1) int32 and the reversed, padded window refpad (B, C+2R+2)
// int32, pre-rotated so that cell (r, c) on wave d reads
// refpad[(r - d + 1) mod (C+2R+2)] (ref1) and the lane after it (ref0).
//
// Two mappings here, chosen by the caller (ops/msa_kernels.launch_shape);
// a warp a job for large batches of short reads is in msa_dp_warp.cu, and
// a warp a band of rows, the mapping of the long-read shapes, in
// msa_dp_band.cu. The cell (dp_cell) and the operand readers are shared
// through msa_dp.cuh.
//
// * rows_per_thread == 1 (R <= 1023): one block per job, thread r owns DP
//   row r, and the block sweeps the R+C anti-diagonals in order. A thread
//   keeps its own row's previous cell and its upper neighbour's wave d-2
//   cell in registers, so the only exchange is the upper neighbour's wave
//   d-1 cell, read from one of two shared-memory wave slots (3 ints per
//   row) and followed by one __syncthreads() per wave.
// * rows_per_thread == J in {2, 4, 8} (1,024 <= R <= 8,191; the band
//   mapping replaced it on every path, and it is launched by mapping=
//   "strided" only, to be compared with): rows are strided over the
//   block, r = t + j * blockDim.x. Both wave slots
//   live in shared memory (24 * (R+1) bytes: 144 KB at R = 6,000, above
//   48 KB only after cudaFuncSetAttribute), the window and the read are
//   staged there too (C + R bytes), and each owned row's diagonal carry
//   (its upper neighbour's wave d-2 cell, 3 ints) sits in a register
//   array of J entries. Wave d writes slot d & 1 and reads only slot
//   (d-1) & 1, so one __syncthreads() per wave still suffices. Cells off
//   the window (c < 0 or c > C) are BAD by definition and no valid cell
//   reads them, so they are skipped: their slot entries and prev codes
//   are not written, and about half the (R+1) x (R+C) sweep is saved.
//
// What bounds it on this card: the sweep is serial in the waves. Every
// wave costs one barrier and about three ints read and three written per
// cell from shared memory, against about 190 SASS instructions a cell; no
// work is shared between jobs, and device memory sees only the inputs,
// three ints out per job, and (fill) one byte per cell, written by
// neighbouring threads to neighbouring bytes. The long mapping is bound
// by registers and shared memory: 65,536 registers per SM give 64 a
// thread at 1,024 threads (__launch_bounds__), which holds J = 8 carries
// of 3 ints but not the own-row cells as well, so those are read back
// from the wave slot (ptxas at J = 8: 63 registers for the score, 64 and
// a 24-byte spill for the fill); the slots take one block per SM at
// R = 6,000.
// One block per job keeps every SM busy once there are hundreds of jobs,
// which the short-read passes have. A long-read launch has few, and a
// job of 6,001 rows alone takes one SM 43-50 ms: msa_dp_band.cu spreads
// such a job over the card.

#include "msa_dp.cuh"

namespace {

// One row per thread (R <= 1023).
template <class Ops, bool WANT_PREVS>
__global__ void msa_dp_kernel(Ops ops, const int* __restrict__ rows_in,
                              int B, int R, int C, Prof P,
                              int* __restrict__ out,
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
  const int BAD = P.BADoff;

  const typename Ops::Job job =
      ops.job(b, R, C, ref_s, false, r, blockDim.x);
  const int read1 = live ? job.read1(r) : '?';
  const int read0 = live ? job.read0(r) : '?';

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
  const int subfloor = sub_floor(max_gain(rows, P));

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
      int ms_val, del_val, ins_val;
      uint8_t code = 0;
      dp_cell<WANT_PREVS>(r, c, C, rows, read1, read0, job.ref1(r, d, c),
                          job.ref0(r, d, c), dd_ms, dd_del, dd_ins, own_ms,
                          own_del, up_ms, up_ins, ins0, subfloor, P, ms_val,
                          del_val, ins_val, code);
      if (WANT_PREVS)
        prevs[(static_cast<size_t>(b) * n_waves + (d - 1)) * Rp1 + r] = code;

      if (r == rows && c >= 1 && c <= C) {
        track(ms_val & SM, c, best0, col0);
        track(del_val & SM, c, best1, col1);
        track(ins_val & SM, c, best2, col2);
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

  if (live && r == rows)
    store_out<Ops>(out, B, b, best0, best1, best2, col0, col1, col2, P);
}

// J rows per thread, strided (R up to J * 1024 - 1).
template <class Ops, bool WANT_PREVS, int J>
__global__ void __launch_bounds__(kMaxThreads, 1)
msa_dp_long_kernel(Ops ops, const int* __restrict__ rows_in,
                   const int* __restrict__ ins0_col, int B, int R, int C,
                   Prof P, int* __restrict__ out,
                   uint8_t* __restrict__ prevs) {
  extern __shared__ int smem[];
  const int Rp1 = R + 1;
  int* wave = smem;  // [2 slots][3 states][R+1]
  uint8_t* stage = reinterpret_cast<uint8_t*>(smem + 6 * Rp1);  // C + R
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int rows = rows_in[b];
  const int SM = ~P.TIMEMASK;
  const int BAD = P.BADoff;
  const typename Ops::Job job = ops.job(b, R, C, stage, true, t, T);
  const int subfloor = sub_floor(max_gain(rows, P));

  // diagonal carry of each owned row: upper neighbour's wave d-2 cell
  int dd_ms[J], dd_del[J], dd_ins[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    dd_ms[j] = dd_del[j] = dd_ins[j] = BAD;
    const int r = t + j * T;
    if (r <= R) {
      const int w0 = r == 0 ? 0 : BAD;
      wave[r] = w0;
      wave[Rp1 + r] = w0;
      wave[2 * Rp1 + r] = w0;
    }
  }
  int best0 = NEG_INF, best1 = NEG_INF, best2 = NEG_INF;
  int col0 = 0, col1 = 0, col2 = 0;
  __syncthreads();

  const int n_waves = R + C;
  for (int d = 1; d <= n_waves; ++d) {
    const int* rd = wave + ((d - 1) & 1) * 3 * Rp1;
    int* wr = wave + (d & 1) * 3 * Rp1;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = t + j * T;
      const int c = d - r;
      if (r > R || c < 0 || c > C) continue;
      int up_ms = BAD, up_del = BAD, up_ins = BAD;
      if (r >= 1) {
        up_ms = rd[r - 1];
        up_del = rd[Rp1 + r - 1];
        up_ins = rd[2 * Rp1 + r - 1];
      }
      const int ins0 = c == 0 ? ins0_col[r] : 0;
      int ms_val, del_val, ins_val;
      uint8_t code = 0;
      dp_cell<WANT_PREVS>(r, c, C, rows, job.read1(r), job.read0(r),
                          job.ref1(r, d, c), job.ref0(r, d, c), dd_ms[j],
                          dd_del[j], dd_ins[j], rd[r], rd[Rp1 + r], up_ms,
                          up_ins, ins0, subfloor, P, ms_val, del_val,
                          ins_val, code);
      if (WANT_PREVS)
        prevs[(static_cast<size_t>(b) * n_waves + (d - 1)) * Rp1 + r] = code;
      if (r == rows && c >= 1) {
        track(ms_val & SM, c, best0, col0);
        track(del_val & SM, c, best1, col1);
        track(ins_val & SM, c, best2, col2);
      }
      wr[r] = ms_val;
      wr[Rp1 + r] = del_val;
      wr[2 * Rp1 + r] = ins_val;
      dd_ms[j] = up_ms;
      dd_del[j] = up_del;
      dd_ins[j] = up_ins;
    }
    __syncthreads();
  }

  const int jr = rows - t;
  if (jr >= 0 && jr % T == 0 && jr / T < J && rows <= R)
    store_out<Ops>(out, B, b, best0, best1, best2, col0, col1, col2, P);
}

// Shared memory of each mapping; must agree with launch_shape in
// ops/msa_kernels.py, which picks the mapping.
size_t smem_bytes(int rows_per_thread, int R, int C) {
  const size_t wave = 6 * static_cast<size_t>(R + 1) * sizeof(int);
  return rows_per_thread == 1 ? wave + C : wave + C + R;
}

template <class K>
cudaError_t raise_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class Ops, bool WANT_PREVS, int J>
cudaError_t launch_long(Ops ops, const int* rows, const int* ins0, int B,
                        int R, int C, const Prof& P, int* out,
                        uint8_t* prevs, int threads, size_t smem,
                        cudaStream_t stream) {
  auto kernel = msa_dp_long_kernel<Ops, WANT_PREVS, J>;
  cudaError_t e = raise_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, threads, smem, stream>>>(ops, rows, ins0, B, R, C, P, out,
                                       prevs);
  return cudaGetLastError();
}

// rows_per_thread, threads and smem come from launch_shape; they are
// checked here against R and C so that a disagreement never launches.
template <class Ops, bool WANT_PREVS>
cudaError_t launch(Ops ops, const int* rows, const int* ins0, int B, int R,
                   int C, const int* prof, int* out, uint8_t* prevs,
                   int rows_per_thread, int threads, int smem_in,
                   cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 0 || C < 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 ||
      static_cast<long long>(threads) * rows_per_thread < R + 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows_per_thread, R, C);
  if (smem != static_cast<size_t>(smem_in) || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const Prof P = load_prof(prof);
  switch (rows_per_thread) {
    case 1: {
      auto kernel = msa_dp_kernel<Ops, WANT_PREVS>;
      cudaError_t e = raise_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<B, threads, smem, stream>>>(ops, rows, B, R, C, P, out,
                                           prevs);
      return cudaGetLastError();
    }
    case 2:
      return launch_long<Ops, WANT_PREVS, 2>(ops, rows, ins0, B, R, C, P,
                                             out, prevs, threads, smem,
                                             stream);
    case 4:
      return launch_long<Ops, WANT_PREVS, 4>(ops, rows, ins0, B, R, C, P,
                                             out, prevs, threads, smem,
                                             stream);
    case 8:
      return launch_long<Ops, WANT_PREVS, 8>(ops, rows, ins0, B, R, C, P,
                                             out, prevs, threads, smem,
                                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// reads (B, R) uint8, refs (B, C) uint8, rows (B,) int32, ins0 (R+1,)
// int32 column-0 boundary (read by the long mapping only), prof: host
// int32[28]; out (3, B) int32 = [score >> SCOREOFFSET, col, state].
cudaError_t msa_score_launch(const uint8_t* reads, const uint8_t* refs,
                             const int* rows, const int* ins0, int B, int R,
                             int C, const int* prof, int* out,
                             int rows_per_thread, int threads, int smem,
                             cudaStream_t stream) {
  return launch<RawOps, false>(RawOps{reads, refs}, rows, ins0, B, R, C,
                               prof, out, nullptr, rows_per_thread, threads,
                               smem, stream);
}

// As msa_score_launch, plus prevs (B, R+C, R+1) uint8 prev-state codes.
cudaError_t msa_fill_launch(const uint8_t* reads, const uint8_t* refs,
                            const int* rows, const int* ins0, int B, int R,
                            int C, const int* prof, int* out, uint8_t* prevs,
                            int rows_per_thread, int threads, int smem,
                            cudaStream_t stream) {
  return launch<RawOps, true>(RawOps{reads, refs}, rows, ins0, B, R, C, prof,
                              out, prevs, rows_per_thread, threads, smem,
                              stream);
}

// msa_score_pallas's operands: read1, read0 (B, R+1) int32, refpad
// (B, C+2R+2) int32, rows (B, 1) int32; out (B, 3) int32.
cudaError_t msa_score_rows_launch(const int* read1, const int* read0,
                                  const int* refpad, const int* rows,
                                  const int* ins0, int B, int R, int C,
                                  const int* prof, int* out,
                                  int rows_per_thread, int threads, int smem,
                                  cudaStream_t stream) {
  return launch<RowOps, false>(RowOps{read1, read0, refpad}, rows, ins0, B,
                               R, C, prof, out, nullptr, rows_per_thread,
                               threads, smem, stream);
}

}  // extern "C"
