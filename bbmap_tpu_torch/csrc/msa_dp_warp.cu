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
// 5.2 ms against 3.4 ms; short fills now run in msa_fill_walk.cu).
//
// Score passes of one R over several windows go in one launch with a
// segment table (msa_score_segments_warp_launch): the fused program's wide
// pass, 128 jobs at (150, 606), alone a 0.32 ms one-row launch that left
// most of the card idle, rides in its narrow pass's launch (32,768 jobs at
// (150, 174)). The wide jobs take the first blocks, so their sweeps of
// C + 32 steps start first and end while the narrow jobs keep the card
// busy; on the H100 above the two passes take 6.60 ms in one launch
// against 6.84 ms in two (PERF.md).

#include "msa_dp.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxWarpRows = 10;          // J <= 10: R + 1 <= 320
constexpr unsigned kFullMask = 0xffffffffu;

// One job b of B, swept by the calling warp: out (3, B) or (B, 3) as the
// operand reader lays it out, and with WANT_PREVS the job's prev codes.
template <class Ops, bool WANT_PREVS, int J>
__device__ __forceinline__ void warp_job(const typename Ops::Job& job, int b,
                                         int B, int R, int C, int rows,
                                         const int* __restrict__ ins0_col,
                                         const Prof& P, int* __restrict__ out,
                                         uint8_t* __restrict__ prevs) {
  const int lane = threadIdx.x & 31;
  const int SM = ~P.TIMEMASK;
  const int BAD = P.BADoff;
  const int Rp1 = R + 1;
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
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msa_dp_warp_kernel(Ops ops, const int* __restrict__ rows_in,
                   const int* __restrict__ ins0_col, int B, int R, int C,
                   Prof P, int* __restrict__ out,
                   uint8_t* __restrict__ prevs) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  warp_job<Ops, WANT_PREVS, J>(ops.direct(b, R, C), b, B, R, C, rows_in[b],
                               ins0_col, P, out, prevs);
}

// Score passes of one R over several windows in one launch: segment s
// holds B[s] raw jobs of C[s] columns and its own out (3, B[s]); its jobs
// take the blocks [block_end[s-1], block_end[s]) of the grid, four a block
// as above. The per-job code is warp_job's.
constexpr int kMaxSegments = 4;

struct Segments {
  const uint8_t* reads[kMaxSegments];
  const uint8_t* refs[kMaxSegments];
  const int* rows[kMaxSegments];
  int* out[kMaxSegments];
  int B[kMaxSegments];
  int C[kMaxSegments];
  int block_end[kMaxSegments];
  int n;
};

template <int J>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msa_score_segments_kernel(Segments S, const int* __restrict__ ins0_col,
                          int R, Prof P) {
  int s = 0;
  while (s + 1 < S.n && static_cast<int>(blockIdx.x) >= S.block_end[s]) ++s;
  const int first = s ? S.block_end[s - 1] : 0;
  const int b = (static_cast<int>(blockIdx.x) - first) * kWarpsPerBlock +
                (threadIdx.x >> 5);
  if (b >= S.B[s]) return;  // the whole warp leaves together
  const RawOps ops{S.reads[s], S.refs[s]};
  warp_job<RawOps, false, J>(ops.direct(b, R, S.C[s]), b, S.B[s], R, S.C[s],
                             S.rows[s][b], ins0_col, P, S.out[s], nullptr);
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
bool bad_shape(int R, int rows_per_lane, int threads, int smem) {
  return R < 0 || rows_per_lane < 1 || rows_per_lane > kMaxWarpRows ||
         rows_per_lane * 32 < R + 1 || (rows_per_lane - 1) * 32 >= R + 1 ||
         threads != kWarpsPerBlock * 32 || smem != 0;
}

template <class Ops, bool WANT_PREVS>
cudaError_t launch(Ops ops, const int* rows, const int* ins0, int B, int R,
                   int C, const int* prof, int* out, uint8_t* prevs,
                   int rows_per_lane, int threads, int smem,
                   cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (C < 0 || bad_shape(R, rows_per_lane, threads, smem))
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

template <int J>
cudaError_t launch_segments_j(const Segments& S, const int* ins0, int R,
                              const Prof& P, int blocks,
                              cudaStream_t stream) {
  msa_score_segments_kernel<J><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      S, ins0, R, P);
  return cudaGetLastError();
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

// Score passes of n <= 4 segments that share R, one launch: segment s is
// reads[s] (B[s], R) uint8, refs[s] (B[s], C[s]) uint8, rows[s] (B[s],)
// int32 and out[s] (3, B[s]) int32, as msa_score_warp_launch takes one
// segment; ins0 (R+1,) int32. The grid holds the segments' blocks in the
// order given. Pointer and size arrays are host memory.
cudaError_t msa_score_segments_warp_launch(
    int n, const uint8_t* const* reads, const uint8_t* const* refs,
    const int* const* rows, int* const* out, const int* B, const int* C,
    const int* ins0, int R, const int* prof, int rows_per_lane, int threads,
    int smem, cudaStream_t stream) {
  if (n < 1 || n > kMaxSegments ||
      bad_shape(R, rows_per_lane, threads, smem))
    return cudaErrorInvalidValue;
  Segments S{};
  long long blocks = 0;
  for (int s = 0; s < n; ++s) {
    if (B[s] < 0 || C[s] < 0) return cudaErrorInvalidValue;
    S.reads[s] = reads[s];
    S.refs[s] = refs[s];
    S.rows[s] = rows[s];
    S.out[s] = out[s];
    S.B[s] = B[s];
    S.C[s] = C[s];
    blocks += (B[s] + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    S.block_end[s] = static_cast<int>(blocks);
  }
  S.n = n;
  if (blocks == 0) return cudaSuccess;
  const Prof P = load_prof(prof);
#define SEG_CASE(J)                                                         \
  case J:                                                                   \
    return launch_segments_j<J>(S, ins0, R, P, static_cast<int>(blocks),    \
                                stream);
  switch (rows_per_lane) {
    SEG_CASE(1) SEG_CASE(2) SEG_CASE(3) SEG_CASE(4) SEG_CASE(5)
    SEG_CASE(6) SEG_CASE(7) SEG_CASE(8) SEG_CASE(9) SEG_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef SEG_CASE
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
