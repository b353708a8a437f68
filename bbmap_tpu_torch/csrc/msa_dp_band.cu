// The DP kernels' mapping for long rows (the long-read shapes, R = 1,024 to
// 8,191 and any window): a job spread over many SMs, a warp a band of
// rows, bands pipelined along the columns, no block-wide barrier.
//
// Same function as the mappings in msa_dp.cu and msa_dp_warp.cu (replaces
// the Pallas TPU kernels msa_score_pallas_t / msa_fill_pallas_t /
// msa_score_pallas, bbmap_tpu/ops/msa_pallas.py:577, :588, :243), same
// dp_cell.
//
// Mapping. A job's R + 1 rows are cut into bands of 32 * J rows. A band is
// one warp (a block of 32 threads) and sweeps its rows as the warp-a-job
// kernel does: lane l owns J consecutive rows, is at column s - l on step
// s, keeps left / up / diagonal neighbours in registers and takes the
// bottom row of the lane above with three __shfl_up_sync a step. What lane
// 0 of band w needs from above, the bottom row of band w - 1, lane 31 of
// that band writes to an edge row in device memory (3 ints a column, (B,
// bands - 1, 3, pitch) int32, L2-resident) and publishes every kChunk
// columns by a release store of its column count; band w takes an acquire
// load of that count once a chunk, loads the chunk with its first kChunk
// lanes and hands lane 0 one column a step by __shfl_sync. Band w trails
// band w - 1 by 31 + kChunk steps; a job takes about C + 32 + (bands - 1) *
// (31 + kChunk) steps of J cells in place of R + C block-wide barriers, and
// every step of every warp evaluates in-window cells only.
//
// No cluster, no co-residency requirement: a block takes its (job, band)
// from a ticket (atomicAdd) and not from blockIdx, so a band only ever
// waits for a ticket drawn before its own, that is for a warp already
// running or done. The edge rows are written once and read once, so there
// is no back-pressure and no ring to size; that also lifts the 8-block
// limit of a portable cluster, so few-job launches may cut a job into
// more, thinner bands (J = 2 or 4) and many-job launches into fewer
// (J = 8), as launch_shape in ops/msa_kernels.py decides from the job
// count. Bands below a job's own last row leave at once.
//
// Prev codes (fill) are row-major here, (B, R + 1, pitch) with pitch = C + 1
// rounded up to 16: a lane walks along its rows, gathers four successive
// codes of a row in a register and stores one aligned 32-bit word, in
// place of four single-byte stores R + 1 bytes apart in the wave-major
// block of the short mappings. The walk kernel takes either layout by a
// base offset and two strides. Codes of row 0 and column 0 are written but
// mean nothing.
//
// What bounds it. With few jobs, latency: the cell chain inside a lane is
// serial (about 700 clocks a cell for a warp alone), a job alone takes
// C + 32 + bands * 47 steps of J cells, 9-10 ms at (6,000, 6,456) and
// J = 2, where one block a job took 42-50 ms. With the card full, the
// integer instruction rate, as in every mapping of this cell: about 300
// clocks a warp and cell (32 cells) on each of an SM's four schedulers,
// whatever the mapping, so from about a hundred jobs on the band mapping
// and the strided one run level (times and the job counts where either is
// ahead: PERF.md, section 6). A copy of the step loop without dp_cell's
// boundary tests for interior lanes was tried and dropped: the doubled
// loop cost more in registers and instruction fetch than the tests save.
// Device memory sees the inputs, one byte a cell of prev codes (fill) and
// 24 bytes a column a band edge, which stay in L2.
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W,
// PACBIO profile, (R, C) = (6,000, 6,456), band / strided: a fill of 1 job
// 9.9 / 49.1 ms, of 16 jobs 12.9 / 49.1 ms (26 % of the 3.41 ms the card's
// schedulers allow for the leanest loop's 184.2 instructions a cell), of 64
// 38.7 / 49.2 ms, of 128 62.5 / 49.2 ms, of 400 175.4 / 196.1 ms; a score
// pass of 16 jobs 11.1 / 42.1 ms, of 256 88.7 / 84.1 ms (52 % of 45.8 ms),
// of 400 138.3 / 167.8 ms. Own instructions a cell (SASS, step loop over
// cells a step): score 202.0 / 179.2 / 172.5 at J = 2 / 4 / 8, fill 227.5 /
// 208.5 / 191.0; registers 64 / 91 / 128 and 78 / 125 / 167, no spill.

#include "msa_dp.cuh"

namespace {

constexpr int kChunk = 16;                // columns an edge hand-over covers
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Row pitches; must agree with prev_pitch / edge_pitch in ops/msa.py and
// ops/msa_kernels.py, which allocate the blocks.
__host__ __device__ inline int prev_pitch(int C) { return (C + 16) / 16 * 16; }
__host__ __device__ inline int edge_pitch(int C) { return (C + 32) / 32 * 32; }

// sync: [0] the ticket counter, [1 + b * bands + w] the columns of band w's
// bottom row that job b has published; all zero at launch.
template <class Ops, bool WANT_PREVS, int J>
__global__ void __launch_bounds__(32)
msa_dp_band_kernel(Ops ops, const int* __restrict__ rows_in,
                   const int* __restrict__ ins0_col, int B, int R, int C,
                   int bands, Prof P, int* __restrict__ out,
                   uint8_t* __restrict__ prevs, int* sync, int* edge) {
  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(sync, 1);
  ticket = __shfl_sync(kFullMask, ticket, 0);
  const int b = ticket / bands;
  const int band = ticket - b * bands;
  if (b >= B) return;
  const int rows = rows_in[b];
  const int band_r0 = band * (32 * J);
  if (band_r0 > rows) return;  // below the job's last row: nothing to do
  const int SM = ~P.TIMEMASK;
  const int BAD = P.BADoff;
  const typename Ops::Job job = ops.direct(b, R, C);
  const int subfloor = sub_floor(max_gain(rows, P));
  const int r0 = band_r0 + lane * J;
  const bool fed = band > 0;
  const bool feeds = band + 1 < bands && band_r0 + 32 * J <= rows;
  int* flag = sync + 1 + b * bands + band;
  const int Ce = edge_pitch(C);
  const size_t eb = static_cast<size_t>(b) * (bands - 1) + band;
  int* edge_out = edge + eb * 3 * Ce;             // written when feeds
  const int* edge_in = edge + (eb - 1) * 3 * Ce;  // read when fed
  const int Cp = prev_pitch(C);
  uint8_t* prow = WANT_PREVS
      ? prevs + (static_cast<size_t>(b) * (R + 1) + r0) * Cp : nullptr;

  // this lane's read characters and its rows' cells of column c-1
  int rd1[J], rd0[J], ms[J], dl[J], in[J];
  unsigned acc[J];  // prev codes of up to four columns, a word a row
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = r0 + j;
    rd1[j] = r <= R ? job.read1(r) : '?';
    rd0[j] = r <= R ? job.read0(r) : '?';
    ms[j] = dl[j] = in[j] = BAD;
    acc[j] = 0;
  }
  // cell (r0 - 1, c - 1): what the shuffles brought one step ago
  int car_ms = BAD, car_del = BAD, car_ins = BAD;
  // lane i < kChunk: column (chunk start + i) of the row above the band
  int e_ms = BAD, e_del = BAD, e_ins = BAD;
  int best0 = NEG_INF, best1 = NEG_INF, best2 = NEG_INF;
  int col0 = 0, col1 = 0, col2 = 0;

  const int n_rows = min(32 * J, R + 1 - band_r0);
  const int n_steps = C + (n_rows + J - 1) / J;  // C + live lanes
  for (int s = 0; s < n_steps; ++s) {
    // bottom row of the lane above after step s-1: cell (r0 - 1, c)
    int up_ms = __shfl_up_sync(kFullMask, ms[J - 1], 1);
    int up_del = __shfl_up_sync(kFullMask, dl[J - 1], 1);
    int up_ins = __shfl_up_sync(kFullMask, in[J - 1], 1);
    if (fed) {
      if ((s & (kChunk - 1)) == 0 && s <= C) {
        const int need = min(s + kChunk, C + 1);
        while (ld_acquire(flag - 1) < need) __nanosleep(32);
        const int ce = s + lane;
        if (lane < kChunk && ce <= C) {
          e_ms = __ldcg(edge_in + ce);
          e_del = __ldcg(edge_in + Ce + ce);
          e_ins = __ldcg(edge_in + 2 * Ce + ce);
        }
      }
      const int src = s & (kChunk - 1);
      const int f_ms = __shfl_sync(kFullMask, e_ms, src);
      const int f_del = __shfl_sync(kFullMask, e_del, src);
      const int f_ins = __shfl_sync(kFullMask, e_ins, src);
      if (lane == 0) {
        up_ms = f_ms;
        up_del = f_del;
        up_ins = f_ins;
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
          const int ins0 = c == 0 ? ins0_col[r] : 0;
          int ms_val, del_val, ins_val;
          uint8_t code = 0;
          dp_cell<WANT_PREVS>(r, c, C, rows, rd1[j], rd0[j], ref1, ref0,
                              dd_ms, dd_del, dd_ins, own_ms, own_del, u_ms,
                              u_ins, ins0, subfloor, P, ms_val, del_val,
                              ins_val, code);
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
        __stcg(edge_out + c, ms[J - 1]);
        __stcg(edge_out + Ce + c, dl[J - 1]);
        __stcg(edge_out + 2 * Ce + c, in[J - 1]);
        if ((c & (kChunk - 1)) == kChunk - 1 || c == C)
          st_release(flag, c + 1);
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
                     int C, int bands, const Prof& P, int* out,
                     uint8_t* prevs, int* sync, int* edge,
                     cudaStream_t stream) {
  if (bands != (R + 32 * J) / (32 * J)) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(B) * bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msa_dp_band_kernel<Ops, WANT_PREVS, J>
      <<<static_cast<unsigned>(blocks), 32, 0, stream>>>(
          ops, rows, ins0, B, R, C, bands, P, out, prevs, sync, edge);
  return cudaGetLastError();
}

// rows_per_lane, threads, smem, the band count and the pitches come from
// ops/msa_kernels.py (launch_shape, band_count, prev_pitch, edge_pitch),
// which allocates sync, edge and prevs by them; they are recomputed here
// so that a disagreement never launches.
template <class Ops, bool WANT_PREVS>
cudaError_t launch(Ops ops, const int* rows, const int* ins0, int B, int R,
                   int C, const int* prof, int* out, uint8_t* prevs,
                   int rows_per_lane, int threads, int smem, int bands,
                   int prev_pitch_in, int edge_pitch_in, int* sync,
                   int* edge, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 0 || C < 0 || threads != 32 || smem != 0 ||
      edge_pitch_in != edge_pitch(C) ||
      (WANT_PREVS && prev_pitch_in != prev_pitch(C)))
    return cudaErrorInvalidValue;
  const Prof P = load_prof(prof);
#define BAND_CASE(J)                                                        \
  case J:                                                                   \
    return launch_j<Ops, WANT_PREVS, J>(ops, rows, ins0, B, R, C, bands, P, \
                                        out, prevs, sync, edge, stream);
  switch (rows_per_lane) {
    BAND_CASE(2) BAND_CASE(4) BAND_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BAND_CASE
}

}  // namespace

extern "C" {

// Operands and out as msa_score_launch / msa_fill_launch /
// msa_score_rows_launch in msa_dp.cu; ins0 (R+1,) int32 is the column-0
// boundary; prevs (B, R+1, prev_pitch) uint8, row-major; sync
// (1 + B * bands,) int32, zero; edge (B, bands - 1, 3, edge_pitch) int32.
cudaError_t msa_score_band_launch(const uint8_t* reads, const uint8_t* refs,
                                  const int* rows, const int* ins0, int B,
                                  int R, int C, const int* prof, int* out,
                                  int rows_per_lane, int threads, int smem,
                                  int bands, int prev_pitch_in,
                                  int edge_pitch_in, int* sync, int* edge,
                                  cudaStream_t stream) {
  return launch<RawOps, false>(RawOps{reads, refs}, rows, ins0, B, R, C,
                               prof, out, nullptr, rows_per_lane, threads,
                               smem, bands, prev_pitch_in, edge_pitch_in,
                               sync, edge, stream);
}

cudaError_t msa_fill_band_launch(const uint8_t* reads, const uint8_t* refs,
                                 const int* rows, const int* ins0, int B,
                                 int R, int C, const int* prof, int* out,
                                 uint8_t* prevs, int rows_per_lane,
                                 int threads, int smem, int bands,
                                 int prev_pitch_in, int edge_pitch_in,
                                 int* sync, int* edge, cudaStream_t stream) {
  return launch<RawOps, true>(RawOps{reads, refs}, rows, ins0, B, R, C, prof,
                              out, prevs, rows_per_lane, threads, smem,
                              bands, prev_pitch_in, edge_pitch_in, sync,
                              edge, stream);
}

cudaError_t msa_score_rows_band_launch(const int* read1, const int* read0,
                                       const int* refpad, const int* rows,
                                       const int* ins0, int B, int R, int C,
                                       const int* prof, int* out,
                                       int rows_per_lane, int threads,
                                       int smem, int bands,
                                       int prev_pitch_in, int edge_pitch_in,
                                       int* sync, int* edge,
                                       cudaStream_t stream) {
  return launch<RowOps, false>(RowOps{read1, read0, refpad}, rows, ins0, B,
                               R, C, prof, out, nullptr, rows_per_lane,
                               threads, smem, bands, prev_pitch_in,
                               edge_pitch_in, sync, edge, stream);
}

}  // extern "C"
