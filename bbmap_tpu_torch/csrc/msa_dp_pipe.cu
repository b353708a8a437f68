// A mapping of the DP kernels for few jobs of up to 1,023 rows: a block a job, a
// warp a band of rows, the bands pipelined along the columns inside the
// block, no block-wide barrier in the sweep, the cell on Hopper's DPX
// instructions. ops/msa_kernels.launch_shape takes it from 700 rows, where
// it beat the one-row and band mappings on the card; below that it lost to
// the one-row mapping at few jobs and is launched by mapping="pipe" only.
//
// Same function as the mappings in msa_dp.cu, msa_dp_warp.cu and
// msa_dp_band.cu (replaces the Pallas TPU kernels msa_score_pallas_t /
// msa_fill_pallas_t / msa_score_pallas, bbmap_tpu/ops/msa_pallas.py:577,
// :588, :243), the same dp_cell in its DPX form, which gives the same bits.
//
// What it replaces and why. The one-row mapping (msa_dp.cu, a thread a
// row) sweeps the R + C anti-diagonals of a job with one __syncthreads()
// and a shared-memory round trip a wave, and every thread evaluates every
// wave, the cells off the window among them (149 of 324 waves at (150,
// 174)). With few jobs an SM holds about five warps, so nothing hides the
// cell's dependent chain or the barrier: 854 clocks a wave at 128 x (150,
// 606), 16.5 % of the bound. That is latency, not arithmetic.
//
// Mapping. The structure of the band mapping (msa_dp_band.cu) inside one
// block. A job's R + 1 rows are cut into bands of 32 * J rows (J = 1 or 2
// rows a lane), a warp a band: lane l owns J consecutive rows, is at
// column s - l on step s, keeps its left / up / diagonal neighbours in
// registers and takes the bottom row of the lane above with three
// __shfl_up_sync a step; a lane evaluates in-window cells only. Lane 31
// of band w hands its bottom row on to band w + 1 through a ring of kRing
// columns x 3 ints in shared memory, publishing its column count every
// kChunk columns with a release store; band w + 1 takes an acquire load of
// that count once a chunk and publishes how far its lane 0 has read (the
// producer's back-pressure: once a chunk it waits until the columns kRing
// before the chunk were read), and its lane 0 reads one column a step
// from the ring. So the warps run a few steps apart and
// never wait on a block-wide barrier; the only one follows the staging of
// the read and the window into shared memory. Band w trails band w - 1 by
// 31 + kChunk steps: a job takes about C + 32 + (bands - 1) * (31 +
// kChunk) steps of J cells, in place of R + C barrier-separated waves.
// Bands below a job's own last row leave at once.
//
// Prev codes (fill) are row-major (B, R + 1, pitch), as the band mapping
// writes them: a lane gathers four successive codes of a row in a register
// and stores one aligned word. The walk kernel takes that layout.
//
// What bounds it. With few jobs (its launches), latency: one dependent cell
// chain a lane and a step. The DPX form shortens the chain (each three-way
// maximum two add-then-max instructions, the source of DEL and INS from
// vibmax's predicate). With the card full, the integer instruction rate,
// as every mapping of this cell.

#include "msa_dp.cuh"

namespace {

constexpr int kChunk = 4;                 // columns a hand-over covers
constexpr int kRing = 16 * kChunk;        // columns the ring holds
constexpr int kPipeMaxThreads = 512;      // 16 bands of 32 or 64 rows
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}

// Row pitch of the row-major prev codes; must agree with prev_pitch in
// ops/msa.py and msa_dp_band.cu.
__host__ __device__ inline int prev_pitch(int C) { return (C + 16) / 16 * 16; }

// Shared memory of a block: the window (C rounded to 16) and the read (R
// rounded to 16) staged, then per band boundary a ring of kRing x 3 ints
// and two counters (columns produced by the band above, columns consumed
// by the band below). Must agree with launch_shape in ops/msa_kernels.py.
__host__ __device__ inline int pipe_smem(int R, int C, int bands) {
  return (C + 15) / 16 * 16 + (R + 15) / 16 * 16 +
         bands * (kRing * 3 + 2) * static_cast<int>(sizeof(int));
}

template <class Ops, bool WANT_PREVS, int J>
__global__ void __launch_bounds__(kPipeMaxThreads)
msa_dp_pipe_kernel(Ops ops, const int* __restrict__ rows_in,
                   const int* __restrict__ ins0_col, int B, int R, int C,
                   int bands, Prof P, int* __restrict__ out,
                   uint8_t* __restrict__ prevs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int band = tid >> 5;
  const int stage = (C + 15) / 16 * 16 + (R + 15) / 16 * 16;
  int* ring_all = reinterpret_cast<int*>(smem + stage);
  // band w's ring (written by w, read by w + 1) and its two counters
  int* produced = ring_all + bands * kRing * 3;
  int* consumed = produced + bands;
  if (tid < bands) {
    produced[tid] = 0;
    consumed[tid] = 0;
  }
  const typename Ops::Job job = ops.job(b, R, C, smem, true, tid,
                                        blockDim.x);
  __syncthreads();
  const int rows = rows_in[b];
  const int band_r0 = band * (32 * J);
  if (band_r0 > rows) return;  // below the job's last row: nothing to do
  const int SM = ~P.TIMEMASK;
  const int BAD = P.BADoff;
  const int subfloor = sub_floor(max_gain(rows, P));
  const int r0 = band_r0 + lane * J;
  const bool fed = band > 0;
  const bool feeds = band + 1 < bands && band_r0 + 32 * J <= rows;
  int* ring_out = ring_all + band * kRing * 3;
  const int* ring_in = ring_all + (band - 1) * kRing * 3;
  const int Cp = prev_pitch(C);
  uint8_t* prow = WANT_PREVS
      ? prevs + (static_cast<size_t>(b) * (R + 1) + r0) * Cp : nullptr;

  int rd1[J], rd0[J], ms[J], dl[J], in[J], ins0[J];
  unsigned acc[J];  // prev codes of up to four columns, a word a row
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = r0 + j;
    rd1[j] = r <= R ? job.read1(r) : '?';
    rd0[j] = r <= R ? job.read0(r) : '?';
    ins0[j] = r <= R ? ins0_col[r] : 0;
    ms[j] = dl[j] = in[j] = BAD;
    acc[j] = 0;
  }
  int car_ms = BAD, car_del = BAD, car_ins = BAD;
  int best0 = NEG_INF, best1 = NEG_INF, best2 = NEG_INF;
  int col0 = 0, col1 = 0, col2 = 0;

  const int n_rows = min(32 * J, R + 1 - band_r0);
  const int n_steps = C + (n_rows + J - 1) / J;  // C + live lanes
  for (int s = 0; s < n_steps; ++s) {
    int up_ms = __shfl_up_sync(kFullMask, ms[J - 1], 1);
    int up_del = __shfl_up_sync(kFullMask, dl[J - 1], 1);
    int up_ins = __shfl_up_sync(kFullMask, in[J - 1], 1);
    if (fed && s <= C) {
      if ((s & (kChunk - 1)) == 0) {
        // the chunk from s on is published; columns before s were read
        const int need = min(s + kChunk, C + 1);
        while (ld_acquire_cta(produced + band - 1) < need) {
        }
        if (lane == 0) st_release_cta(consumed + band, s);
      }
      if (lane == 0) {
        const int* slot = ring_in + (s % kRing) * 3;
        up_ms = slot[0];
        up_del = slot[1];
        up_ins = slot[2];
      }
    }
    const int c = s - lane;
    if (c >= 0 && c <= C && r0 <= R) {
      const int ref1 = job.ref1(r0, r0 + c, c);
      const int ref0 = job.ref0(r0, r0 + c, c);
      const bool flush = (c & 3) == 3 || c == C;
      int dd_ms = car_ms, dd_del = car_del, dd_ins = car_ins;
      int u_ms = up_ms, u_ins = up_ins;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + j;
        if (r <= R) {
          const int own_ms = ms[j], own_del = dl[j], own_ins = in[j];
          int ms_val, del_val, ins_val;
          uint8_t code = 0;
          dp_cell<WANT_PREVS, true>(
              r, c, C, rows, rd1[j], rd0[j], ref1, ref0, dd_ms, dd_del,
              dd_ins, own_ms, own_del, u_ms, u_ins, ins0[j], subfloor, P,
              ms_val, del_val, ins_val, code);
          if (WANT_PREVS) {
            acc[j] |= static_cast<unsigned>(code) << ((c & 3) * 8);
            if (flush) {
              *reinterpret_cast<unsigned*>(
                  prow + static_cast<size_t>(j) * Cp + (c & ~3)) = acc[j];
              acc[j] = 0;
            }
          }
          if (r == rows && c >= 1) {
            track(ms_val & SM, c, best0, col0);
            track(del_val & SM, c, best1, col1);
            track(ins_val & SM, c, best2, col2);
          }
          dd_ms = own_ms;
          dd_del = own_del;
          dd_ins = own_ins;
          u_ms = ms_val;
          u_ins = ins_val;
          ms[j] = ms_val;
          dl[j] = del_val;
          in[j] = ins_val;
        }
      }
      if (feeds && lane == 31) {
        // the slots of this chunk's columns held columns kRing before
        // them: wait, once a chunk, until the band below has read those
        if ((c & (kChunk - 1)) == 0)
          while (ld_acquire_cta(consumed + band + 1) <=
                 c + kChunk - 1 - kRing) {
          }
        int* slot = ring_out + (c % kRing) * 3;
        slot[0] = ms[J - 1];
        slot[1] = dl[J - 1];
        slot[2] = in[J - 1];
        if ((c & (kChunk - 1)) == kChunk - 1 || c == C)
          st_release_cta(produced + band, c + 1);
      }
    }
    car_ms = up_ms;
    car_del = up_del;
    car_ins = up_ins;
  }

  const int jr = rows - band_r0;
  if (rows <= R && jr < 32 * J && lane == jr / J)
    store_out<Ops>(out, B, b, best0, best1, best2, col0, col1, col2, P);
}

template <class Ops, bool WANT_PREVS, int J>
cudaError_t launch_j(Ops ops, const int* rows, const int* ins0, int B, int R,
                     int C, const Prof& P, int* out, uint8_t* prevs,
                     int threads, int smem, cudaStream_t stream) {
  const int bands = (R + 32 * J) / (32 * J);
  if (threads != 32 * bands || threads > kPipeMaxThreads ||
      smem != pipe_smem(R, C, bands) ||
      static_cast<size_t>(smem) > kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = msa_dp_pipe_kernel<Ops, WANT_PREVS, J>;
  cudaError_t e = raise_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, threads, smem, stream>>>(ops, rows, ins0, B, R, C, bands, P,
                                       out, prevs);
  return cudaGetLastError();
}

// rows_per_lane, threads and smem come from launch_shape in
// ops/msa_kernels.py; they are recomputed here so that a disagreement
// never launches.
template <class Ops, bool WANT_PREVS>
cudaError_t launch(Ops ops, const int* rows, const int* ins0, int B, int R,
                   int C, const int* prof, int* out, uint8_t* prevs,
                   int rows_per_lane, int threads, int smem,
                   cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 0 || C < 0 || R > 1023) return cudaErrorInvalidValue;
  const Prof P = load_prof(prof);
  switch (rows_per_lane) {
    case 1:
      return launch_j<Ops, WANT_PREVS, 1>(ops, rows, ins0, B, R, C, P, out,
                                          prevs, threads, smem, stream);
    case 2:
      return launch_j<Ops, WANT_PREVS, 2>(ops, rows, ins0, B, R, C, P, out,
                                          prevs, threads, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The DPX check: every operand set through dp_cell's two forms.
// in: n x 17 int32 (r, c, C, rows, read1, read0, ref1, ref0, dd_ms,
// dd_del, dd_ins, own_ms, own_del, up_ms, up_ins, ins0, subfloor); out: n
// x 2 forms x 4 int32 (ms, del, ins, code).
template <bool DPX>
__device__ void cell_form(const int* x, const Prof& P, int* o) {
  int ms, dl, in;
  uint8_t code = 0;
  dp_cell<true, DPX>(x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8],
                     x[9], x[10], x[11], x[12], x[13], x[14], x[15], x[16],
                     P, ms, dl, in, code);
  o[0] = ms;
  o[1] = dl;
  o[2] = in;
  o[3] = code;
}

__global__ void dp_cell_check_kernel(const int* in, int n, Prof P,
                                     int* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int* x = in + static_cast<size_t>(t) * 17;
  int* o = out + static_cast<size_t>(t) * 8;
  cell_form<false>(x, P, o);
  cell_form<true>(x, P, o + 4);
}

// __viaddmax_s32(a, b, c) beside max(a + b wrapped, c): out n x 2.
__global__ void addmax_probe_kernel(const int* abc, int n, int* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int a = abc[3 * t], b = abc[3 * t + 1], c = abc[3 * t + 2];
  out[2 * t] = __viaddmax_s32(a, b, c);
  out[2 * t + 1] = addmax<false>(a, b, c);
}

}  // namespace

extern "C" {

int msa_dp_pipe_smem(int R, int C, int bands) {
  return pipe_smem(R, C, bands);
}

// Operands and out as msa_score_launch / msa_fill_launch /
// msa_score_rows_launch in msa_dp.cu; ins0 (R+1,) int32 the column-0
// boundary; prevs (B, R+1, prev_pitch) uint8, row-major.
cudaError_t msa_score_pipe_launch(const uint8_t* reads, const uint8_t* refs,
                                  const int* rows, const int* ins0, int B,
                                  int R, int C, const int* prof, int* out,
                                  int rows_per_lane, int threads, int smem,
                                  cudaStream_t stream) {
  return launch<RawOps, false>(RawOps{reads, refs}, rows, ins0, B, R, C,
                               prof, out, nullptr, rows_per_lane, threads,
                               smem, stream);
}

cudaError_t msa_fill_pipe_launch(const uint8_t* reads, const uint8_t* refs,
                                 const int* rows, const int* ins0, int B,
                                 int R, int C, const int* prof, int* out,
                                 uint8_t* prevs, int rows_per_lane,
                                 int threads, int smem, cudaStream_t stream) {
  return launch<RawOps, true>(RawOps{reads, refs}, rows, ins0, B, R, C, prof,
                              out, prevs, rows_per_lane, threads, smem,
                              stream);
}

cudaError_t msa_score_rows_pipe_launch(const int* read1, const int* read0,
                                       const int* refpad, const int* rows,
                                       const int* ins0, int B, int R, int C,
                                       const int* prof, int* out,
                                       int rows_per_lane, int threads,
                                       int smem, cudaStream_t stream) {
  return launch<RowOps, false>(RowOps{read1, read0, refpad}, rows, ins0, B,
                               R, C, prof, out, nullptr, rows_per_lane,
                               threads, smem, stream);
}

cudaError_t dp_cell_check_launch(const int* in, int n, const int* prof,
                                 int* out, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const Prof P = load_prof(prof);
  dp_cell_check_kernel<<<(n + 127) / 128, 128, 0, stream>>>(in, n, P, out);
  return cudaGetLastError();
}

cudaError_t addmax_probe_launch(const int* abc, int n, int* out,
                                cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  addmax_probe_kernel<<<(n + 127) / 128, 128, 0, stream>>>(abc, n, out);
  return cudaGetLastError();
}

}  // extern "C"
