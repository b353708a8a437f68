// Fill (K3) and traceback walk of short DP jobs in one kernel, the prev
// codes held in shared memory.
//
// Replaces the Pallas TPU kernel msa_fill_pallas_t
// (bbmap_tpu/ops/msa_pallas.py:588) followed by the device walk
// _walk_device (bbmap_tpu/ops/msa_jax.py:451), which the fused program
// runs back to back. Same function as msa_fill (msa_dp.cu, msa_dp_warp.cu)
// followed by msa_walk (msa_walk.cu) from the fill's own column and state:
// the same dp_cell and operand reader and the same walk_job (msa_dp.cuh),
// out (3, B) int32 [score >> SCOREOFFSET, col, state], then syms
// (B, steps) uint8 in walk order, zero after the last symbol, out_len,
// gaps and row_end (B,) int32. Every job's rows must lie in 0..R (every
// caller passes R).
//
// Where the codes live. A job keeps the codes of its cells 1 <= r <= R,
// 1 <= c <= C row-major in shared memory, row r at byte (r - 1) * pitch,
// pitch chosen by the caller against bank conflicts (ops/msa_kernels.
// fill_walk_pitch). One byte a cell (ms | del << 2 | ins << 4, as the
// two-kernel route stores them) at byte c - 1, or, packed, four bits a
// cell at byte (c - 1) / 2, low nibble for odd c: ms is 0-2, del 0 or 1 and
// ins 0 or 2, so ms | del << 2 | (ins >> 1) << 3 holds the code. Every row
// is written by the one thread that owns it, in column order, so a packed
// byte is put together in a register and stored once. Cells off the
// window are never stored, and nothing of the codes reaches device memory:
// the two-kernel route wrote one byte a cell of the (R+C) x (R+1) wave
// block there (4.0e8 B for 8,192 jobs at (150, 174)) and the walk read it
// back with a miss at every step. After the sweep one thread a job walks
// from (R, col, state) reading shared memory only.
//
// The mapping: a block a job, one thread a row (R <= 1,023), the waves in
// order with a __syncthreads() each, as msa_dp.cu's one-row mapping, but a
// thread evaluates only its in-window cells (0 <= c <= C): a wave's other
// threads pass straight to the barrier. No in-window cell reads a wave slot
// entry that an off-window cell would have written. A block of 1,024
// threads (R = 1,023) launches only at 64 registers a thread or fewer:
// ptxas gives it 40 (both packings, no spill, on the H100 machine's nvcc);
// chip_smoke.py reads the count and fails above 64. __launch_bounds__(1024)
// made ptxas spend 47 registers and 20 more instructions a cell, and the
// T fill 5 % slower (PERF.md).
//
// What bounds it: the instruction rate of the sweep, as the fill kernels;
// the walk adds about 90 instructions a step, a chain of dependent
// shared-memory loads, one thread a job. Measured with chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W, 8,192 jobs of (150, 174) walked 190
// steps: 2.43 ms a byte a cell (2.59 packed), against 3.53 ms for K3
// one-row + the walk kernel; 64 jobs of (150, 606) 0.37 ms. A warp a job
// (the msa_dp_warp.cu sweep, codes in shared memory) was swept beside it
// and lost at both shapes (PERF.md). ops/msa_kernels.fill_walk_shape packs
// the codes where a byte block leaves fewer than 4 blocks an SM and the
// launch is large.

#include "msa_dp.cuh"

namespace {

// The window staged in shared memory, rounded to 16 bytes; the codes
// follow it.
__host__ __device__ inline int window_bytes(int C) {
  return (C + 15) / 16 * 16;
}

// Bytes a row of codes needs: C, or packed (C + 1) / 2.
inline int row_bytes(int C, bool packed) { return packed ? (C + 1) / 2 : C; }

// The row's code of column c (1 <= c <= C), stored by the row's owner in
// column order; `pending` carries a packed byte's low nibble.
template <bool PACK>
__device__ __forceinline__ void put_code(uint8_t* row, int c, int C,
                                         int code, int& pending) {
  if (!PACK) {
    row[c - 1] = static_cast<uint8_t>(code);
    return;
  }
  const int nib = (code & 7) | ((code >> 2) & 8);
  if (c & 1) {
    pending = nib;
    if (c == C) row[(c - 1) >> 1] = static_cast<uint8_t>(nib);
  } else {
    row[(c - 1) >> 1] = static_cast<uint8_t>(pending | (nib << 4));
  }
}

// The codes in shared memory, read back as prev-code bytes for walk_job.
template <bool PACK>
struct SmemCodes {
  const uint8_t* codes;
  int pitch;
  __device__ int operator()(int r, int c) const {
    const uint8_t* row = codes + (r - 1) * pitch;
    if (!PACK) return row[c - 1];
    const int nib = (row[(c - 1) >> 1] >> (((c - 1) & 1) << 2)) & 15;
    return (nib & 7) | ((nib & 8) << 2);
  }
};

template <bool PACK>
__global__ void msa_fill_walk_row_kernel(
    const uint8_t* __restrict__ reads, const uint8_t* __restrict__ refs,
    const int* __restrict__ rows_in, const int* __restrict__ ins0_col, int B,
    int R, int C, int pitch, int steps, Prof P, int* __restrict__ out,
    uint8_t* __restrict__ syms, int* __restrict__ out_len,
    int* __restrict__ gaps_out, int* __restrict__ row_end) {
  extern __shared__ int smem[];
  const int Rp1 = R + 1;
  int* wave = smem;  // [2 slots][3 states][R+1]
  uint8_t* ref_s = reinterpret_cast<uint8_t*>(smem + 6 * Rp1);
  uint8_t* codes = ref_s + window_bytes(C);  // R x pitch
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const bool live = r <= R;
  const int rows = rows_in[b];
  const int SM = ~P.TIMEMASK;
  const int BAD = P.BADoff;

  const RawOps::Job job =
      RawOps{reads, refs}.job(b, R, C, ref_s, false, r, blockDim.x);
  const int read1 = live ? job.read1(r) : '?';
  const int read0 = live ? job.read0(r) : '?';
  const int ins0 = live ? ins0_col[r] : 0;
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
  uint8_t* my_row = codes + (r - 1) * pitch;  // r >= 1
  int pend = 0;
  __syncthreads();

  const int n_waves = R + C;
  for (int d = 1; d <= n_waves; ++d) {
    const int c = d - r;
    if (live && c >= 0 && c <= C) {
      const int* rd = wave + ((d - 1) & 1) * 3 * Rp1;
      int up_ms = BAD, up_del = BAD, up_ins = BAD;
      if (r >= 1) {
        up_ms = rd[r - 1];
        up_del = rd[Rp1 + r - 1];
        up_ins = rd[2 * Rp1 + r - 1];
      }
      int ms_val, del_val, ins_val;
      uint8_t code = 0;
      dp_cell<true>(r, c, C, rows, read1, read0, job.ref1(r, d, c),
                    job.ref0(r, d, c), dd_ms, dd_del, dd_ins, own_ms,
                    own_del, up_ms, up_ins, ins0, subfloor, P, ms_val,
                    del_val, ins_val, code);
      if (r >= 1 && c >= 1) put_code<PACK>(my_row, c, C, code, pend);
      if (r == rows && c >= 1) {
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

  // every code is in shared memory now and the wave slots are free (the
  // first int takes the symbol count); the thread of row `rows` holds the
  // last-row best and walks
  int* walked = wave;
  const bool has = rows >= 0 && rows <= R;
  uint8_t* sym_row = syms + static_cast<size_t>(b) * steps;
  if (r == (has ? rows : 0)) {
    int st = 0, col = 0;
    if (has) {
      int score;
      pick_best(best0, best1, best2, col0, col1, col2, st, score, col);
      out[b] = score >> P.SCOREOFFSET;
      out[B + b] = col;
      out[2 * B + b] = st;
    }
    const WalkEnd e = walk_job(SmemCodes<PACK>{codes, pitch}, job.read,
                               job.ref, R, C, col, st, steps, sym_row);
    out_len[b] = e.n;
    gaps_out[b] = e.gaps;
    row_end[b] = e.row;
    *walked = e.n;
  }
  __syncthreads();
  for (int i = *walked + r; i < steps; i += blockDim.x) sym_row[i] = 0;
}

// Shared memory of a block: the two wave slots, the window and the codes;
// must agree with fill_walk_shape in ops/msa_kernels.py, which picks the
// pitch.
size_t smem_bytes(int R, int C, int pitch) {
  return 6 * static_cast<size_t>(R + 1) * sizeof(int) + window_bytes(C) +
         static_cast<size_t>(R) * pitch;
}

template <bool PACK>
cudaError_t launch(const uint8_t* reads, const uint8_t* refs,
                   const int* rows, const int* ins0, int B, int R, int C,
                   const Prof& P, int steps, int* out, uint8_t* syms,
                   int* out_len, int* gaps, int* row_end, int threads,
                   size_t smem, int pitch, cudaStream_t stream) {
  const auto kernel = msa_fill_walk_row_kernel<PACK>;
  const cudaError_t e = raise_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, threads, smem, stream>>>(reads, refs, rows, ins0, B, R, C,
                                       pitch, steps, P, out, syms, out_len,
                                       gaps, row_end);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// reads (B, R) uint8, refs (B, C) uint8, rows (B,) int32 in 0..R, ins0
// (R+1,) int32 column-0 boundary, prof: host int32[28], steps >= 1; out
// (3, B) int32, syms (B, steps) uint8, out_len / gaps / row_end (B,)
// int32. packed 0 (a byte a cell) or 1 (four bits); threads, smem and
// pitch from fill_walk_shape, checked here so that a disagreement never
// launches.
cudaError_t msa_fill_walk_launch(const uint8_t* reads, const uint8_t* refs,
                                 const int* rows, const int* ins0, int B,
                                 int R, int C, const int* prof, int steps,
                                 int* out, uint8_t* syms, int* out_len,
                                 int* gaps, int* row_end, int packed,
                                 int threads, int smem, int pitch,
                                 cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 1 || C < 1 || steps < 1 || (packed != 0 && packed != 1) ||
      pitch < row_bytes(C, packed != 0) ||
      threads != (R + 32) / 32 * 32 || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  const size_t want = smem_bytes(R, C, pitch);
  if (want != static_cast<size_t>(smem) || want > kMaxSmem)
    return cudaErrorInvalidValue;
  const Prof P = load_prof(prof);
  if (packed)
    return launch<true>(reads, refs, rows, ins0, B, R, C, P, steps, out,
                        syms, out_len, gaps, row_end, threads, want, pitch,
                        stream);
  return launch<false>(reads, refs, rows, ins0, B, R, C, P, steps, out, syms,
                       out_len, gaps, row_end, threads, want, pitch, stream);
}

}  // extern "C"
