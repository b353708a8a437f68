// Traceback walk over the fill kernel's prev codes, one launch a batch.
//
// Replaces the device walk of the JAX package, _walk_device
// (bbmap_tpu/ops/msa_jax.py:451, a compiled lax.scan inside the fused
// program); the port ran it as a Python loop of tensor steps, about 35
// launches a step. Same function, walk_step in msa_dp.cuh: start at row R,
// column col0[b], state st0[b], at most `steps` symbols; row_end > 0
// marks a walk that was cut. Symbols are written in walk order (the
// reverse of the match string) to syms (B, steps), zero after the last
// one, as the plain version lays them out; out_len is their count.
//
// Both fill layouts are affine in (row, col), so the walk takes a base
// offset and two strides: cell (row, col) of job b is byte b * job_stride
// + base + row * row_stride + col * col_stride. The wave-major block
// (R+C, R+1) of the short mappings, byte (row + col - 1, row), is base
// -(R+1), strides (R+2, R+1); the row-major block (R+1, pitch) of the band
// mapping is base 0, strides (pitch, 1).
//
// What bounds it: latency. A job's walk is a chain of dependent steps: the
// next cell's address needs the state read from this cell's code. Read
// from device memory, each step was a miss to L2 or HBM (a long-read job's
// block is 38.8 MB): about 470 clocks a step, 1.5 ms for 16 jobs of
// (6,000, 6,456). So a warp walks one job (a block of one warp) out of
// shared memory:
//
// - the job's read and window are staged once (R + C bytes) where they fit
//   beside the tiles, else read in place;
// - the codes come in tiles of T = 64 rows x W = 128 columns. A step goes
//   up, left or up-left, so from (row, col) the next steps stay in rows
//   <= row and columns <= col: a tile is anchored with the walk at its
//   bottom row and near its right edge, and the W - T spare columns take
//   the drift of deletions. Lane 0 follows the codes until the walk
//   leaves the tile (upward or to the left), ends, reaches column 0 or
//   has made kBuf steps, and records only each step's state: a step is a
//   shared-memory load, a shift and two moves;
// - while it walks, the 32 lanes have the next tile on its way into the
//   second buffer (cp.async, 16 bytes a lane and copy): the tile above and
//   to the left where a diagonal walk would leave this one, with kMargin
//   columns to its right for the drift of insertions. A walk that leaves
//   the tile into the prefetched one goes on there; one that does not
//   (long deletions) waits for a tile loaded at its new position;
// - the warp then turns the recorded states into symbols, 32 steps at a
//   time: a scan of the moves over the lanes gives each step's cell, its
//   lane reads the read and window characters and stores the symbol, 32
//   consecutive bytes a store; the 'X' steps past column 0 are written
//   the same way, with no code read.
// Tiles are for the row-major block, whose tile rows load as 16-byte
// copies (tile columns start on a multiple of 16, the pitch is one). Any
// other layout (the wave-major block of the short fills, off both paths)
// is walked by the same loop reading each code straight from device
// memory through the affine addressing, as before the tiles: a tile a
// byte a cell cost 8 KB of loads for a 190-step walk. All offsets are
// 64-bit: a 56-job long-read block passes 2**31 bytes.
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, 16
// and 400 jobs of (6,000, 6,456), full length: about 0.35 ms a launch,
// 110-145 clocks a walked step (lane 0's step is 20 instructions, one
// dependent chain through a shared-memory load). Swept in one call: tiles
// of 16, 32 and 64 rows with 32 or 64 spare columns, prefetch on and off;
// 64 x 128 with prefetch was level with 64 x 96 and ahead of the rest,
// prefetch worth 15-20 % at 400 jobs; lane 0 decoding its own symbols
// took about 300 clocks a step (PERF.md).

#include <climits>

#include "msa_dp.cuh"

namespace {

constexpr int T = 64;        // rows of a tile
constexpr int W = 128;       // columns of a tile: T + 64 for deletions
constexpr int kBuf = 128;    // steps lane 0 records between two decodes
constexpr int kMargin = 16;  // columns a prefetched tile keeps right of
                             // the diagonal guess
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Shared memory of a block: with tiles two of them, the state buffer and,
// staged, the read and the window.
inline size_t walk_smem(int R, int C, bool tiled, bool staged) {
  return (tiled ? 2 * static_cast<size_t>(T) * W : 0) + kBuf +
         (staged ? static_cast<size_t>(round16(R)) + round16(C) : 0);
}

// A tile: rows [rlo, rlo + T), columns [clo, clo + W).
struct Tile {
  int rlo, clo;
};

// The tile whose bottom row is `row` and whose right edge keeps `margin`
// columns right of column cc; clo is a multiple of 16.
__device__ __forceinline__ Tile tile_at(int row, int cc, int margin) {
  return Tile{row - T + 1, ((cc + margin) & ~15) - W + 16};
}

__device__ __forceinline__ bool inside(const Tile& t, int row, int cc) {
  return row >= t.rlo && row < t.rlo + T && cc >= t.clo && cc < t.clo + W;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The warp starts the copy of tile t of the job's row-major codes pv
// (cell (r, c) at pv[r * rs + c], rs and pv 16-byte aligned) into buf, row
// i of the tile at buf + i * W, as 16-byte asynchronous copies of aligned
// row pieces: rows 1..R, pieces that start at column 0 or later and end
// inside the row's rs bytes.
__device__ __forceinline__ void load_tile(uint8_t* buf, const Tile& t,
                                          const uint8_t* pv, long long rs,
                                          int R, int lane) {
  constexpr int kPieces = W / 16;
  for (int k = lane; k < T * kPieces; k += 32) {
    const int i = k / kPieces, j = (k % kPieces) * 16;
    const int r = t.rlo + i, c = t.clo + j;
    if (r >= 1 && r <= R && c >= 0 && c < rs)
      cp_async16(buf + i * W + j, pv + r * rs + c);
  }
  cp_async_commit();
}

// One recorded step: the state goes to the buffer, (r, c) moves, and the
// predecessor's state comes from the cell's code.
__device__ __forceinline__ void record_step(uint8_t* sbuf, int k, int code,
                                            int& r, int& c, int& s) {
  sbuf[k] = static_cast<uint8_t>(s);
  r -= s != MODE_DEL;
  c -= s != MODE_INS;
  s = (code >> (2 * s)) & 3;
}

__global__ void __launch_bounds__(32)
msa_walk_kernel(const uint8_t* __restrict__ prevs,
                const uint8_t* __restrict__ reads,
                const uint8_t* __restrict__ refs,
                const int* __restrict__ col0, const int* __restrict__ st0,
                int R, int C, int steps, long long job_stride,
                long long base, long long rs, long long cs, bool tiled,
                bool staged, uint8_t* __restrict__ syms,
                int* __restrict__ out_len, int* __restrict__ gaps_out,
                int* __restrict__ row_end) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const sbuf = smem + (tiled ? 2 * T * W : 0);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const uint8_t* pv = prevs + b * job_stride + base;
  const uint8_t* rd = reads + static_cast<size_t>(b) * R;
  const uint8_t* rf = refs + static_cast<size_t>(b) * C;
  if (staged) {
    uint8_t* s_rd = sbuf + kBuf;
    uint8_t* s_rf = s_rd + round16(R);
    for (int i = lane; i < R; i += 32) s_rd[i] = rd[i];
    for (int i = lane; i < C; i += 32) s_rf[i] = rf[i];
    rd = s_rd;
    rf = s_rf;
    __syncwarp();
  }
  uint8_t* const sym_row = syms + static_cast<size_t>(b) * steps;

  // every lane keeps the walk's state; lane 0 advances it
  int row = R, col = col0[b], st = st0[b], gaps = 0, n = 0;
  Tile cur{INT_MIN / 2, INT_MIN / 2}, nxt = cur;
  bool have_nxt = false;
  int cb = 0;  // the buffer holding cur
  while (n < steps && row > 0) {
    if (col <= 0) {  // the rest is 'X', each step up and left
      const int cnt = min(steps - n, row);
      for (int i = lane; i < cnt; i += 32) sym_row[n + i] = 'X';
      n += cnt;
      row -= cnt;
      col -= cnt;
      break;
    }
    const int cc = min(col, C);
    if (tiled && !inside(cur, row, cc)) {
      if (have_nxt) cp_async_wait_all();
      if (have_nxt && inside(nxt, row, cc)) {
        cur = nxt;
        cb ^= 1;
      } else {
        cur = tile_at(row, cc, 0);
        load_tile(smem + cb * T * W, cur, pv, rs, R, lane);
        cp_async_wait_all();
      }
      __syncwarp();
      // prefetch where a diagonal walk leaves cur: its row above, as many
      // columns left as rows climbed
      const int gr = cur.rlo - 1;
      const int gc = max(cc - (row - cur.rlo + 1), 1);
      have_nxt = gr >= 1;
      if (have_nxt) {
        nxt = tile_at(gr, gc, kMargin);
        load_tile(smem + (cb ^ 1) * T * W, nxt, pv, rs, R, lane);
      }
    }
    // lane 0 follows the codes and records each step's state only; it
    // stops where the walk leaves the tile, reaches row 0 or column 0, or
    // has made min(kBuf, steps - n) steps
    int k = 0, r = row, c = col, s = st;
    if (lane == 0) {
      const int lim = min(kBuf, steps - n);
      if (tiled) {
        const int off = cb * T * W - cur.rlo * W - cur.clo;
        const int rstop = max(cur.rlo, 1), cstop = max(cur.clo, 1);
#pragma unroll 1
        for (; k < lim && r >= rstop && c >= cstop; ++k)
          record_step(sbuf, k, smem[off + r * W + min(c, C)], r, c, s);
      } else {  // the codes straight from device memory
#pragma unroll 1
        for (; k < lim && r >= 1 && c >= 1; ++k)
          record_step(sbuf, k, pv[r * rs + min(c, C) * cs], r, c, s);
      }
    }
    k = __shfl_sync(kFull, k, 0);
    __syncwarp();
    // the warp turns the k states into symbols: step m's cell is the
    // start less the moves of steps 0..m-1 (a scan over the warp, 32
    // steps at a time, row moves in the low half, column moves high)
    int dr = 0, dc = 0;
    for (int m0 = 0; m0 < k; m0 += 32) {
      const int m = m0 + lane;
      const int sm = m < k ? sbuf[m] : MODE_MS;
      const int own = m < k ? (sm != MODE_DEL) | ((sm != MODE_INS) << 16) : 0;
      int v = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
      }
      if (m < k) {
        const int before = v - own;
        const int rm = row - dr - (before & 0xffff);
        const int cm = col - dc - (before >> 16);
        const int r_ = rf[min(cm, C) - 1];
        sym_row[n + m] = static_cast<uint8_t>(
            walk_symbol(sm, rd[rm - 1], r_, cm, C));
        gaps += sm == MODE_DEL && r_ == '-';
      }
      const int all = __shfl_sync(kFull, v, 31);
      dr += all & 0xffff;
      dc += all >> 16;
    }
    n += k;
    row = __shfl_sync(kFull, r, 0);
    col = __shfl_sync(kFull, c, 0);
    st = __shfl_sync(kFull, s, 0);
    __syncwarp();
  }
  if (have_nxt) cp_async_wait_all();
  gaps = __reduce_add_sync(kFull, gaps);
  for (int i = n + lane; i < steps; i += 32) sym_row[i] = 0;
  if (lane == 0) {
    out_len[b] = n;
    gaps_out[b] = gaps;
    row_end[b] = row;
  }
}

}  // namespace

extern "C" {

// prevs (B, job_stride) uint8 in the layout (base, row_stride, col_stride),
// reads (B, R) uint8, refs (B, C) uint8, col0 and st0 (B,) int32; syms
// (B, steps) uint8, out_len / gaps / row_end (B,) int32. steps >= 1. The
// wrapper checks that cells (1..R, 1..C) lie inside a job's block. The
// launcher tiles the codes where the layout allows it, and stages the
// read and the window where they fit a block's shared memory beside the
// rest.
cudaError_t msa_walk_launch(const uint8_t* prevs, const uint8_t* reads,
                            const uint8_t* refs, const int* col0,
                            const int* st0, int B, int R, int C, int steps,
                            long long job_stride, long long base,
                            long long row_stride, long long col_stride,
                            uint8_t* syms, int* out_len, int* gaps,
                            int* row_end, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 1 || C < 1 || steps < 1) return cudaErrorInvalidValue;
  // tiles need the rows of a job's codes contiguous and 16-byte aligned
  const bool tiled = col_stride == 1 && row_stride % 16 == 0 &&
                     base % 16 == 0 && job_stride % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(prevs) % 16 == 0;
  const bool staged = walk_smem(R, C, tiled, true) <= kMaxSmem;
  const size_t smem = walk_smem(R, C, tiled, staged);
  const cudaError_t e = raise_smem(msa_walk_kernel, smem);
  if (e != cudaSuccess) return e;
  msa_walk_kernel<<<B, 32, smem, stream>>>(
      prevs, reads, refs, col0, st0, R, C, steps, job_stride, base,
      row_stride, col_stride, tiled, staged, syms, out_len, gaps, row_end);
  return cudaGetLastError();
}

}  // extern "C"
