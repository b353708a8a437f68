// The DP kernels' mapping for short reads (R + 1 <= 320 rows): a warp a
// job, four jobs a block, no shared memory and no __syncthreads().
//
// Same function as the mappings in msa_dp.cu (replaces the Pallas TPU
// kernels msa_score_pallas_t / msa_fill_pallas_t / msa_score_pallas,
// bbmap_tpu/ops/msa_pallas.py:577, :588, :243), same dp_cell.
//
// Lane l owns the J consecutive rows l*J .. l*J + J-1 and sweeps them
// along the columns: at step s it is at column c = s - l and evaluates
// its J cells of that column from top to bottom. Inside a lane the left
// neighbour (r, c-1) is the row's own register from the last step, the
// upper neighbour (r-1, c) is the cell just evaluated, and the diagonal
// (r-1, c-1) is the upper row's register before it was overwritten. Across
// lanes only the bottom row of lane l-1 is needed, one step old: three
// __shfl_up_sync at the top of a step bring cell (l*J - 1, c), and the
// same three values held one step longer are cell (l*J - 1, c-1). The
// window characters depend on c alone and are read from device memory
// once a step (neighbouring lanes read neighbouring bytes).
//
// C + (live lanes) steps of J cells take the place of R + C barriers, and
// only in-window cells are evaluated: a lane idles while c < 0 or c > C
// (31 of C + 32 steps at most). Every in-window cell of rows 0..R is
// evaluated, those below a job's own row count as BAD, as dp_cell defines
// them.
//
// Prev codes (fill) keep the layout the plain version and the walk kernel
// read, byte (d-1, r) with d = r + c of the job's (R+C, R+1) block. A
// lane's J bytes of one step lie on J different waves, so they are stored
// as single bytes straight to device memory; codes of row 0, of column 0
// and of cells off the window are not written (no walk reads them).
//
// What bounds it: the instruction rate. At J = 5 one pass of the step loop is
// 773 SASS instructions for 5 cells (921 with prev codes), and the chain
// inside a lane is serial (cell j needs cell j-1 of the same step), so the
// card is kept busy by the number of warps resident (96 registers a thread
// for the score at J = 5, 111 for the fill: 20 and 16 warps an SM), not by
// parallelism inside a warp. Measured with chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W: the score pass takes 6.5 ms at 32,768 x (150, 174)
// against 12.2 ms in the one-row mapping, 61 % of what the card's
// schedulers allow for these instructions. Two cases go the other way, and
// launch_shape gives them the one-row mapping: with few jobs (128 at
// (150, 606): 0.98 ms against 0.32 ms; the two tie at 1,024 jobs and the
// sweep wins from 2,048) most warp slots of the card stay empty while each
// warp runs its long serial sweep, and the fill's
// scattered byte stores cost more than the sweep saves (8,192 x (150, 174):
// 5.2 ms against 3.4 ms). Keeping a short job's prev codes in shared memory
// and walking them there would remove those stores.

#include "msa_dp.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxWarpRows = 10;          // J <= 10: R + 1 <= 320
constexpr unsigned kFullMask = 0xffffffffu;

template <class Ops, bool WANT_PREVS, int J>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msa_dp_warp_kernel(Ops ops, const int* __restrict__ rows_in,
                   const int* __restrict__ ins0_col, int B, int R, int C,
                   Prof P, int* __restrict__ out,
                   uint8_t* __restrict__ prevs) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int rows = rows_in[b];
  const int SM = ~P.TIMEMASK;
  const int BAD = P.BADoff;
  const int Rp1 = R + 1;
  const typename Ops::Job job = ops.direct(b, R, C);
  const int subfloor = sub_floor(max_gain(rows, P));
  const int r0 = lane * J;
  const size_t pbase = static_cast<size_t>(b) * (R + C) * Rp1;

  // this lane's read characters and its rows' cells of column c-1
  int rd1[J], rd0[J], ms[J], dl[J], in[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = r0 + j;
    rd1[j] = r <= R ? job.read1(r) : '?';
    rd0[j] = r <= R ? job.read0(r) : '?';
    ms[j] = dl[j] = in[j] = BAD;
  }
  // cell (r0 - 1, c - 1): what the shuffles brought one step ago
  int car_ms = BAD, car_del = BAD, car_ins = BAD;
  int best0 = NEG_INF, best1 = NEG_INF, best2 = NEG_INF;
  int col0 = 0, col1 = 0, col2 = 0;

  const int n_live = (R + J) / J;  // lanes that own a row <= R
  const int n_steps = C + n_live;
  for (int s = 0; s < n_steps; ++s) {
    // bottom row of the lane above after step s-1: cell (r0 - 1, c)
    const int up_ms = __shfl_up_sync(kFullMask, ms[J - 1], 1);
    const int up_del = __shfl_up_sync(kFullMask, dl[J - 1], 1);
    const int up_ins = __shfl_up_sync(kFullMask, in[J - 1], 1);
    const int c = s - lane;
    if (c >= 0 && c <= C && r0 <= R) {
      const int ref1 = job.ref1(r0, r0 + c, c);
      const int ref0 = job.ref0(r0, r0 + c, c);
      int dd_ms = car_ms, dd_del = car_del, dd_ins = car_ins;
      int u_ms = up_ms, u_ins = up_ins;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + j;
        if (r <= R) {
          const int own_ms = ms[j], own_del = dl[j], own_ins = in[j];
          const int ins0 = c == 0 ? ins0_col[r] : 0;
          int ms_val, del_val, ins_val;
          uint8_t code = 0;
          dp_cell<WANT_PREVS>(r, c, C, rows, rd1[j], rd0[j], ref1, ref0,
                              dd_ms, dd_del, dd_ins, own_ms, own_del, u_ms,
                              u_ins, ins0, subfloor, P, ms_val, del_val,
                              ins_val, code);
          if (WANT_PREVS && r >= 1 && c >= 1)
            prevs[pbase + static_cast<size_t>(r + c - 1) * Rp1 + r] = code;
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
    }
    car_ms = up_ms;
    car_del = up_del;
    car_ins = up_ins;
  }

  if (rows >= 0 && rows <= R && lane == rows / J)
    store_out<Ops>(out, B, b, best0, best1, best2, col0, col1, col2, P);
}

template <class Ops, bool WANT_PREVS, int J>
cudaError_t launch_j(Ops ops, const int* rows, const int* ins0, int B, int R,
                     int C, const Prof& P, int* out, uint8_t* prevs,
                     int threads, cudaStream_t stream) {
  const int warps = threads / 32;
  msa_dp_warp_kernel<Ops, WANT_PREVS, J>
      <<<(B + warps - 1) / warps, threads, 0, stream>>>(ops, rows, ins0, B,
                                                        R, C, P, out, prevs);
  return cudaGetLastError();
}

// rows_per_lane, threads and smem come from launch_shape in
// ops/msa_kernels.py; they are checked here against R so that a
// disagreement never launches.
template <class Ops, bool WANT_PREVS>
cudaError_t launch(Ops ops, const int* rows, const int* ins0, int B, int R,
                   int C, const int* prof, int* out, uint8_t* prevs,
                   int rows_per_lane, int threads, int smem,
                   cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 0 || C < 0 || rows_per_lane < 1 || rows_per_lane > kMaxWarpRows ||
      rows_per_lane * 32 < R + 1 || (rows_per_lane - 1) * 32 >= R + 1 ||
      threads != kWarpsPerBlock * 32 || smem != 0)
    return cudaErrorInvalidValue;
  const Prof P = load_prof(prof);
#define WARP_CASE(J)                                                        \
  case J:                                                                   \
    return launch_j<Ops, WANT_PREVS, J>(ops, rows, ins0, B, R, C, P, out,   \
                                        prevs, threads, stream);
  switch (rows_per_lane) {
    WARP_CASE(1) WARP_CASE(2) WARP_CASE(3) WARP_CASE(4) WARP_CASE(5)
    WARP_CASE(6) WARP_CASE(7) WARP_CASE(8) WARP_CASE(9) WARP_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef WARP_CASE
}

}  // namespace

extern "C" {

// Operands and outputs as msa_score_launch / msa_fill_launch /
// msa_score_rows_launch in msa_dp.cu; ins0 (R+1,) int32 is the column-0
// boundary.
cudaError_t msa_score_warp_launch(const uint8_t* reads, const uint8_t* refs,
                                  const int* rows, const int* ins0, int B,
                                  int R, int C, const int* prof, int* out,
                                  int rows_per_lane, int threads, int smem,
                                  cudaStream_t stream) {
  return launch<RawOps, false>(RawOps{reads, refs}, rows, ins0, B, R, C,
                               prof, out, nullptr, rows_per_lane, threads,
                               smem, stream);
}

cudaError_t msa_fill_warp_launch(const uint8_t* reads, const uint8_t* refs,
                                 const int* rows, const int* ins0, int B,
                                 int R, int C, const int* prof, int* out,
                                 uint8_t* prevs, int rows_per_lane,
                                 int threads, int smem,
                                 cudaStream_t stream) {
  return launch<RawOps, true>(RawOps{reads, refs}, rows, ins0, B, R, C, prof,
                              out, prevs, rows_per_lane, threads, smem,
                              stream);
}

cudaError_t msa_score_rows_warp_launch(const int* read1, const int* read0,
                                       const int* refpad, const int* rows,
                                       const int* ins0, int B, int R, int C,
                                       const int* prof, int* out,
                                       int rows_per_lane, int threads,
                                       int smem, cudaStream_t stream) {
  return launch<RowOps, false>(RowOps{read1, read0, refpad}, rows, ins0, B,
                               R, C, prof, out, nullptr, rows_per_lane,
                               threads, smem, stream);
}

}  // extern "C"
