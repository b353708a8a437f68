// Batched banded edit distance, one launch a call.
//
// Replaces the JAX package's banded_device._program
// (bbmap_tpu/ops/banded_device.py:34-90, a jitted lax.scan over the rows
// with the band of 2E+1 diagonals on the lanes), which Dedupe runs once for
// each read it checks with e= and twice for each containment check (here:
// the block mapping below for the first, the containment mapping for the
// second). The function, per pair (a of length la, b of length lb, E =
// max_edits, BIG = E + 1, band cell d at column j = i - E + d of row i):
//
//   row 0:  global  v[d] = j        where 0 <= j <= lb, else BIG
//           infix   v[d] = 0        where 0 <= j <= lb, else BIG
//   row i (1 <= i <= min(la, La)), cells with 1 <= j <= lb, else BIG:
//           c[d] = min(v[d] + (a[i-1] != b[j-1]), v[d+1] + 1)
//           c[d] = min_{e <= d} (c[e] + d - e)        (the insertion sweep)
//           v[d] = min(c[d], BIG)
//   result: global  v[lb - la + E] where |lb - la| <= E, else BIG
//           infix   min of v[d] over la - E + d in [0, lb], else BIG
//
// Bytes are compared raw (ASCII, N and IUPAC codes match only themselves);
// a position outside b's array reads 255, as the JAX package's padding
// does. Once every cell of a row is BIG the rest of the scan leaves them
// BIG and the result is BIG, so a pair stops there: the same value, and
// the work the data needs (unrelated pairs saturate within a few rows).
//
// Two mappings, which the launcher picks from E; together they cover every
// E:
// - a thread a pair (2E + 1 <= 64; dedupe's e=2 gives 5 cells, its
//   containment check E = 2 tol): the band in registers, a template over
//   the width (exact up to 15 cells, then 32 and 64), and the window of b
//   as packed bytes that slide one byte a row (a funnel shift a word): one
//   byte of a and one of b loaded a row, both for the next row while this
//   one computes. The caller stages a and b pair-minor (position-major,
//   byte (pos, pair) at pos * n + pair) so that the threads of a warp read
//   neighbouring bytes; a query shared by every pair is passed once, with
//   a pair stride of 0.
// - a warp a pair (wider bands, so 3 chunks or more): the band on the
//   lanes in chunks of 32 cells, in registers up to 32 chunks
//   (2E + 1 <= 1,024). The cell above
//   (v[d+1]) comes by __shfl_down_sync, the insertion sweep is an
//   inclusive min scan over the lanes by __shfl_up_sync with the carry
//   handed from one chunk to the next, and the window slides by a shuffle
//   with one new byte a row. Past 32 chunks the band lives in a scratch
//   row a pair in device memory (no cap on E).
// - four pairs a thread (quad_pairs, 2E + 1 <= 15: dedupe's e=2 and its
//   in-block containment check's E = 4), where the launcher is asked for
//   it and the operands allow it: the four pairs in the byte lanes of a
//   word, each cell's value as a run of low bits (a min is an OR, + 1 a
//   shift), b read a word of four pairs a position. Both modes and every
//   length of thread_pair, the same results; the setup a pair and the
//   operations a cell fall about four times.
//
// The block mapping (banded_block_kernel, dedupe's store check): many
// queries against one length class of kept sequences in one launch, where
// the thread mapping above made a launch a query. What bounded that was
// not arithmetic: a launch, an upload and a synchronisation a read, about
// 500 warps a launch, and a dependent byte load from device memory every
// row. Here a block takes a tile of kTile = 128 class sequences (a thread
// each) and a group of queries; it copies the tile (its rows of 128
// position-major bytes, 16-byte cp.async pieces) and the group's query
// bytes into shared memory once, and each thread runs its sequence against
// every query of the group in turn with thread_pair (the band in
// registers, the same early stop). A query's flag, any(d <= E) over the
// class, is one __any_sync and a plain store of 1 by lane 0 of a warp that
// found one, into flags the caller zeroed: the same bytes whatever the
// order of the blocks. The launcher sizes the query groups so that the
// grid (tiles x groups) gives the card several blocks an SM at dedupe's
// class sizes (10^3 to 10^5 sequences). A second mode runs the queries
// against each other: the lower triangle j < i, d(query i, query j) <= E
// as a (Q, Q) byte matrix. Where a tile and its group would not fit a
// block's shared memory (contigs), the same loop reads them in place. On
// the four-lane body (banded_block_quad_kernel) a thread takes four
// neighbouring sequences of a tile of kQuadTile = 512, whose bytes at a
// position are one aligned word of the position-major class, read in
// place, against the query's byte repeated in the four lanes.
//
// The containment mapping (dedupe's containment check): a block of reads
// against the windows that the host cut from the containers kept before
// the block, in one launch. A pair table (query column, window column,
// window length) names the pairs; each pair runs forward and as its
// reverse complement, read from the forward column backward with each
// byte through the complement table (kComp, core/bases COMP_ASCII: ACGTacgt
// complemented, every other byte as it is), which a block stages in shared
// memory beside an identity table, so that both orientations run the same
// instructions. A query's flag, any(d <= tol) at E = 2 tol (infix), is a
// warp vote and a plain store of 1 into flags the caller zeroed:
// order-free. The work is a few thousand band cells a read, far below a
// microsecond of the card's rate; what bounds it is the chain of up to
// ~150 dependent rows a pair, a row of 9 cells (tol 2) ~100 instructions
// that wait on each other. Five mappings, which the caller picks
// (banded_device.contained_mapping, from the pair count, tol and the
// operands' lengths):
// - "split" (4 tol + 1 <= 13, below ~2,300 pairs, where the card is
//   nearly empty): a warp a pair, a half-warp an orientation, the row
//   chain split over the lanes as min-plus maps composed in registers and
//   joined down the lanes (banded_contained_split_kernel, below);
// - "staged" (4 tol + 1 <= 64 cells, a block's rows within kStageMax
//   bytes): a thread an orientation of a pair, the block's 64 pairs' query
//   columns and windows copied to shared memory pair-major first, then
//   thread_pair in groups of rows (no branch inside a group, the early
//   stop at its end, so that rows overlap);
// - "ring" (the same band past kStageMax: contigs): the same body read in
//   place, each byte loaded a group of rows before its row;
// - "warp" (past 64 cells, tol >= 16): a warp an orientation (warp_pair),
//   its bytes from a ring across the lanes, a chunk of 32 rows ahead;
// - "inplace" (every tol; taken only when forced): the first body, a
//   thread (past 64 cells a warp) an orientation, read in place a row
//   ahead, the early stop tested every row.
// Past 32 chunks (tol >= 256) "warp" and "inplace" keep the band in a
// scratch row of device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadMaxCells = 64;
constexpr int kWarpRegChunks = 32;

// Byte (pos, pair) of a tensor of any strides lies at base + pos * ps +
// pair * pp; la and lb at their base + pair * stride.
struct Pairs {
  const uint8_t* a;
  long long a_ps, a_pp;
  const int* la;
  long long la_pp;
  const uint8_t* b;
  long long b_ps, b_pp;
  const int* lb;
  long long lb_pp;
  int n, La, Lb, E, infix;
  int* out;
};

__device__ __forceinline__ unsigned byte_at(const uint8_t* row, long long ps,
                                            int pos, int L) {
  return (pos >= 0 && pos < L) ? row[pos * ps] : 255u;
}

__device__ __forceinline__ int row0_cell(int d, int w, int E, int lb,
                                         int infix) {
  const int j = d - E;
  const bool ok = d < w && j >= 0 && j <= lb;
  return ok ? (infix ? 0 : j) : E + 1;
}

// The complement of each byte (core/bases.COMP_ASCII): A<->T, C<->G,
// a<->t, c<->g, every other byte itself.
__constant__ uint8_t kComp[256] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
    32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
    48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63,
    64, 84, 66, 71, 68, 69, 70, 67, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 83, 65, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95,
    96, 116, 98, 103, 100, 101, 102, 99, 104, 105, 106, 107, 108, 109, 110,
    111,
    112, 113, 114, 115, 97, 117, 118, 119, 120, 121, 122, 123, 124, 125, 126,
    127,
    128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138, 139, 140, 141, 142,
    143,
    144, 145, 146, 147, 148, 149, 150, 151, 152, 153, 154, 155, 156, 157, 158,
    159,
    160, 161, 162, 163, 164, 165, 166, 167, 168, 169, 170, 171, 172, 173, 174,
    175,
    176, 177, 178, 179, 180, 181, 182, 183, 184, 185, 186, 187, 188, 189, 190,
    191,
    192, 193, 194, 195, 196, 197, 198, 199, 200, 201, 202, 203, 204, 205, 206,
    207,
    208, 209, 210, 211, 212, 213, 214, 215, 216, 217, 218, 219, 220, 221, 222,
    223,
    224, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 235, 236, 237, 238,
    239,
    240, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250, 251, 252, 253, 254,
    255};

// Byte off of a, through the table tab when MAP (the staged identity or
// complement), else as it is.
template <bool MAP>
__device__ __forceinline__ unsigned a_byte(const uint8_t* a, long long off,
                                           const uint8_t* tab) {
  const unsigned x = a[off];
  return MAP ? tab[x] : x;
}

// ---------------------------------------------------------------------
// One row i of a thread's band (W >= 2E + 1 cells, w = 2E + 1 of them
// live): v the band, win the window (byte d is b[i - E - 1 + d]), ai =
// a[i - 1] and nb the byte that enters the window after the row. Returns
// the row's least cell.
// ---------------------------------------------------------------------
template <int W>
__device__ __forceinline__ int band_row(int (&v)[W],
                                        uint32_t (&win)[(W + 3) / 4],
                                        unsigned ai, unsigned nb, int i,
                                        int E, int w, int lb) {
  constexpr int NW = (W + 3) / 4;
  const int BIG = E + 1;
  const uint32_t rep = ai * 0x01010101u;
  uint32_t m[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) m[j] = __vcmpne4(win[j], rep);
  const int dlo = E + 1 - i, dhi = min(lb + E - i, w - 1);
  int r = BIG, rowmin = BIG;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const int ne = (m[d >> 2] >> (8 * (d & 3))) & 1;
    const int up = (d + 1 < W ? v[d + 1] : BIG) + 1;
    int c = min(v[d] + ne, up);
    c = (d >= dlo && d <= dhi) ? c : BIG;
    r = min(c, r + 1);
    v[d] = min(r, BIG);
    rowmin = min(rowmin, v[d]);
  }
#pragma unroll
  for (int j = 0; j + 1 < NW; ++j)
    win[j] = __funnelshift_r(win[j], win[j + 1], 8);
  win[NW - 1] = (win[NW - 1] >> 8) | (nb << 24);
  return rowmin;
}

// ---------------------------------------------------------------------
// A thread a pair, W >= 2E + 1 band cells in registers: one pair's
// distance, a (la <= La bytes) and b (Lb bytes, 255 past them) read at a
// stride of a_ps / b_ps bytes a position (a_ps may be negative), in device
// or shared memory; MAP: a's bytes through the 256-byte table tab. The
// rows run in groups of K (unrolled, no branch inside a group, so that the
// next row's first cells can start while this one's sweep runs on), the
// early stop tested at a group's end (a band that saturated stays so: the
// same result), each byte loaded K rows before its row (a ring of K bytes
// of a and K of b in registers); K = 1: a row at a time, its bytes loaded
// during the row before.
// ---------------------------------------------------------------------
template <int W, bool MAP = false, int K = 1>
__device__ __forceinline__ int thread_pair(const uint8_t* a, long long a_ps,
                                           int la, int La, const uint8_t* b,
                                           long long b_ps, int lb, int Lb,
                                           int E, int infix,
                                           const uint8_t* tab = nullptr) {
  const int w = 2 * E + 1, BIG = E + 1;
  if (!infix && abs(lb - la) > E) return BIG;
  constexpr int NW = (W + 3) / 4;
  constexpr int TOP = 4 * NW - 1;     // the window's last byte
  int v[W];
#pragma unroll
  for (int d = 0; d < W; ++d) v[d] = row0_cell(d, w, E, lb, infix);
  // byte d of the window at row i is b[i - E - 1 + d]
  uint32_t win[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t x = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x |= byte_at(b, b_ps, 4 * k + q - E, Lb) << (8 * q);
    win[k] = x;
  }
  const int rows = min(la, La);
  // ra[k] / rb[k]: a[i - 1] (raw) and the byte that enters the window
  // after row i, for the next row i of slot k ((i - 1) mod K)
  unsigned ra[K], rb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ra[k] = k < rows ? a[k * a_ps] : 0u;
    rb[k] = byte_at(b, b_ps, k + 1 - E + TOP, Lb);
  }
  int i = 1;
  for (; i + K - 1 <= rows; i += K) {
    int rowmin = BIG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned ai = MAP ? tab[ra[k]] : ra[k], nb = rb[k];
      ra[k] = i + k + K <= rows ? a[(i + k + K - 1) * a_ps] : 0u;
      rb[k] = byte_at(b, b_ps, i + k + K - E + TOP, Lb);
      rowmin = band_row<W>(v, win, ai, nb, i + k, E, w, lb);
    }
    if (rowmin > E) return BIG;
  }
  // the last rows, fewer than K
#pragma unroll
  for (int k = 0; k + 1 < K; ++k) {
    if (i + k > rows) break;
    band_row<W>(v, win, MAP ? tab[ra[k]] : ra[k], rb[k], i + k, E, w, lb);
  }
  int res = BIG;
  const int df = lb - la + E;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    if (infix) {
      const int jsf = la - E + d;
      if (d < w && jsf >= 0 && jsf <= lb) res = min(res, v[d]);
    } else if (d == df) {
      res = v[d];
    }
  }
  return res;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    banded_thread_kernel(Pairs p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.n) return;
  p.out[t] = thread_pair<W>(p.a + t * p.a_pp, p.a_ps, p.la[t * p.la_pp],
                            p.La, p.b + t * p.b_pp, p.b_ps,
                            p.lb[t * p.lb_pp], p.Lb, p.E, p.infix);
}

// ---------------------------------------------------------------------
// Four pairs a thread, one in each byte lane of a word (2E + 1 <= 15
// cells, E <= 7). A cell's value x in 0..BIG (BIG = E + 1 <= 8) is held as
// its headroom D(x) = (1 << (BIG - x)) - 1, the low BIG - x bits of its
// lane (BIG is 0). On that code min(x, y) is D(x) | D(y), x + 1 saturated
// at BIG is (D(x) >> 1) within the lane, the clamp at BIG costs nothing and
// x <= E is bit 0: a cell of four pairs is a few logic operations, a min
// of four lanes one OR. b is read
// a word a position: four pairs' bytes at one position, from pair-minor
// operands whose words are 4-byte aligned. A cell whose column lies
// outside a lane's b (j < 1 or j > lb) is BIG whatever its bytes, so the
// window needs no 255 there; bytes past Lb read 255 (a lane's lb may pass
// Lb, as in thread_pair).
// ---------------------------------------------------------------------
constexpr int kQuadMaxCells = 15;
constexpr uint32_t kOnes = 0x01010101u;
constexpr uint32_t kLow7 = 0x7f7f7f7fu;
constexpr uint32_t kHigh = 0x80808080u;

// 0xff in each byte lane whose top bit is set in x, else 0 (prmt replicates
// a selected byte's sign bit where its selector nibble has bit 3 set)
__device__ __forceinline__ uint32_t spread_top(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u),
      "r"(0xba98u));
  return r;
}

// 0xff in each byte lane where x is not zero
__device__ __forceinline__ uint32_t nonzero_lanes(uint32_t x) {
  return spread_top(((x & kLow7) + kLow7) | x);
}

// 0xff in each byte lane where x >= y (both below 128 in every lane)
__device__ __forceinline__ uint32_t ge_lanes(uint32_t x, uint32_t y) {
  return spread_top((x | kHigh) - y);
}

// 0xff in each lane of live whose value v[q] is > at
__device__ __forceinline__ uint32_t lanes_above(const int (&v)[4], int at,
                                                uint32_t live) {
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (v[q] > at) m |= 0xffu << (8 * q);
  return m & live;
}


// Four pairs' bytes of a, position after position from 0: one word of
// four pairs (pair-minor, 4-byte aligned) or, with a pair stride of 0, one
// byte every pair shares.
struct AWord {
  const uint8_t* a;
  long long ps;
  __device__ uint32_t next() {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(a);
    a += ps;
    return w;
  }
};

struct AByte {
  const uint8_t* a;
  long long ps;
  __device__ uint32_t next() {
    const uint32_t w = *a * kOnes;
    a += ps;
    return w;
  }
};

// Four pairs' bytes of b, position after position from 0, 255 past Lb
// (``left`` positions before it).
struct BWord {
  const uint8_t* b;
  long long ps;
  int left;
  __device__ uint32_t next() {
    const uint32_t w = left > 0 ? *reinterpret_cast<const uint32_t*>(b)
                                : 0xffffffffu;
    b += ps;
    --left;
    return w;
  }
};

// The four results, each lane's D of its distance, from the last band:
// global v[lb - la + E]; infix the min of v[d] over la - E + d in [0, lb].
template <int W>
__device__ __forceinline__ uint32_t quad_pick(const uint32_t (&v)[W],
                                              const int (&la)[4],
                                              const int (&lb)[4], int E,
                                              int infix) {
  uint32_t pick = 0;
  if (!infix) {
    uint32_t df = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      df |= static_cast<uint32_t>((lb[q] - la[q] + E) & 0xff) << (8 * q);
#pragma unroll
    for (int d = 0; d < W; ++d)
      pick |= v[d] & ~nonzero_lanes(df ^ (d * kOnes));
  } else {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = min(W - 1, lb[q] + E - la[q]);
      lo |= (h < 0 ? 16u : static_cast<uint32_t>(max(0, E - la[q])))
            << (8 * q);
      hi |= static_cast<uint32_t>(max(h, 0)) << (8 * q);
    }
#pragma unroll
    for (int d = 0; d < W; ++d)
      pick |= v[d] & ge_lanes(d * kOnes, lo) & ge_lanes(hi, d * kOnes);
  }
  return pick;
}

// The distances of four pairs (W = 2E + 1 cells): lane q (byte q of the
// words the readers a and b give, position after position, each read
// once) is pair (a of length la[q], b of length lb[q]);
// lanes: 0xff in each byte lane that holds a pair. Returns each lane's D of
// its distance (0: BIG, or no pair); distance = BIG - popc(byte), and <= E
// where bit 0 is set. FREEZE: the lanes' rows differ, and a lane past its
// last row keeps its band (a byte-lane select a cell). The scan stops once
// every live lane's band is BIG, thread_pair's exact stop taken lane by
// lane.
template <int W, bool FREEZE, class A, class B>
__device__ __forceinline__ uint32_t quad_pairs(A a, B b,
                                               const int (&la)[4],
                                               const int (&lb)[4],
                                               uint32_t lanes, int La,
                                               int E, int infix) {
  const int BIG = E + 1;
  int rows[4];
  uint32_t alive = 0, lbc = 0;
  int last = 0, rows_min = 0x7fffffff, lb_min = 0x7fffffff;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    rows[q] = min(la[q], La);
    const uint32_t m = 0xffu << (8 * q);
    if ((lanes & m) && (infix || abs(lb[q] - la[q]) <= E)) {
      alive |= m;
      last = max(last, rows[q]);
      rows_min = min(rows_min, rows[q]);
      lb_min = min(lb_min, lb[q]);
    }
    lbc |= static_cast<uint32_t>(min(lb[q], 127)) << (8 * q);
  }
  if (!alive) return 0;
  // row 0, and the window of row 1: win[d] holds b at i - E - 1 + d, valid
  // (vwin) where 0 <= i - E - 1 + d < lb
  uint32_t v[W], win[W], vwin[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const int j = d - E;
    v[d] = j < 0 ? 0u
                 : ((infix ? (1u << BIG) - 1 : (1u << (W - d)) - 1) * kOnes)
                       & ge_lanes(lbc, j * kOnes) & alive;
    vwin[d] = j < 0 ? 0u : ge_lanes(lbc, (j + 1) * kOnes);
    win[d] = j < 0 ? 0xffffffffu : b.next();
  }
  uint32_t aw = last >= 1 ? a.next() : 0u;
  uint32_t nb = b.next();                 // enters the window after row 1
  for (int i = 1; i <= last; ++i) {
    const uint32_t a_next = i < last ? a.next() : 0u;
    const uint32_t nb_next = b.next();    // b at i + 1 + E
    const uint32_t act = FREEZE && i > rows_min
                             ? lanes_above(rows, i - 1, alive) : alive;
    uint32_t r = 0, any = 0, s = (v[0] >> 1) & kLow7;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      // up: v[d + 1] + 1, s: v[d] + 1 (the previous row's)
      const uint32_t up = d + 1 < W ? (v[d + 1] >> 1) & kLow7 : 0u;
      const uint32_t ne = nonzero_lanes(win[d] ^ aw);
      const uint32_t c = ((v[d] & ~ne) | s | up) & vwin[d];
      r = c | ((r >> 1) & kLow7);
      v[d] = FREEZE ? (r & act) | (v[d] & ~act) : r;
      any |= r;
      s = up;
    }
#pragma unroll
    for (int d = 0; d + 1 < W; ++d) {
      win[d] = win[d + 1];
      vwin[d] = vwin[d + 1];
    }
    win[W - 1] = nb;
    vwin[W - 1] = i + E < lb_min ? 0xffffffffu : lanes_above(lb, i + E,
                                                             alive);
    nb = nb_next;
    aw = a_next;
    if (!(any & act & kOnes)) break;
  }
  return quad_pick<W>(v, la, lb, E, infix) & alive;
}

// A thread four consecutive pairs: b pair-minor with a pair stride of 1 and
// 4-byte aligned words; a the same (AWORD) or one query (a pair stride of
// 0); FREEZE where la has a pair stride (the pairs' rows may differ).
template <int W, bool AWORD, bool FREEZE>
__global__ void __launch_bounds__(kThreads)
    banded_thread_quad_kernel(Pairs p) {
  const long long k0 = 4 * (blockIdx.x * (long long)blockDim.x +
                            threadIdx.x);
  if (k0 >= p.n) return;
  const int cnt = static_cast<int>(min(4LL, p.n - k0));
  int la[4], lb[4];
  uint32_t lanes = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    la[q] = q < cnt ? p.la[(k0 + q) * p.la_pp] : 0;
    lb[q] = q < cnt ? p.lb[(k0 + q) * p.lb_pp] : 0;
    if (q < cnt) lanes |= 0xffu << (8 * q);
  }
  const BWord b{p.b + k0, p.b_ps, p.Lb};
  uint32_t pick;
  if constexpr (AWORD)
    pick = quad_pairs<W, FREEZE>(AWord{p.a + k0, p.a_ps}, b, la, lb, lanes,
                                 p.La, p.E, p.infix);
  else
    pick = quad_pairs<W, FREEZE>(AByte{p.a, p.a_ps}, b, la, lb, lanes,
                                 p.La, p.E, p.infix);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < cnt)
      p.out[k0 + q] = p.E + 1 - __popc((pick >> (8 * q)) & 0xffu);
}

// One chunk of 32 cells of a row in the warp mapping: x is the cell before
// the insertion sweep, carry the swept value of the chunk's cell -1.
// Returns the swept, unclamped value; carry becomes lane 31's.
__device__ __forceinline__ int sweep_chunk(int x, int lane, int& carry) {
  int s = x - lane;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s = min(s, y);
  }
  const int r = min(s + lane, carry + lane + 1);
  carry = __shfl_sync(kFull, r, 31);
  return r;
}

// 32-cell chunks of the band at E
__host__ __device__ inline int warp_chunks(int E) {
  return (2 * E + 1 + 31) / 32;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// ---------------------------------------------------------------------
// A warp a pair, NC chunks of 32 cells in registers: the pair's distance
// on every lane, in the layout of thread_pair (MAP: a through tab).
// RING: the bytes of a and the bytes that enter the window come from a
// ring across the lanes, lane l holding those of row i0 + l for a chunk
// of 32 rows from i0, with the next chunk's loads in flight (a byte is
// loaded 32 to 63 rows before its row, and a row takes it by a shuffle);
// else each row's bytes are loaded during the row before.
// ---------------------------------------------------------------------
template <int NC, bool MAP = false, bool RING = false>
__device__ __forceinline__ int warp_pair(const uint8_t* a, long long a_ps,
                                         int la, int La, const uint8_t* b,
                                         long long b_ps, int lb, int Lb,
                                         int E, int infix, int lane,
                                         const uint8_t* tab = nullptr) {
  const int w = 2 * E + 1, BIG = E + 1;
  if (!infix && abs(lb - la) > E) return BIG;
  constexpr int TOP = 32 * NC - 1;
  int v[NC];
  unsigned wb[NC];                            // b[i - E - 1 + d] at row i
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 32 * c + lane;
    v[c] = row0_cell(d, w, E, lb, infix);
    wb[c] = byte_at(b, b_ps, d - E, Lb);
  }
  const int rows = min(la, La);
  unsigned ai = 0u, nb = 0u, ca = 0u, cb = 0u, na = 0u, nx = 0u;
  if constexpr (RING) {
    // this chunk (rows 1-32) and the next (rows 33-64)
    ca = lane < rows ? a[lane * a_ps] : 0u;
    cb = byte_at(b, b_ps, 1 + lane - E + TOP, Lb);
    na = lane + 32 < rows ? a[(lane + 32) * a_ps] : 0u;
    nx = byte_at(b, b_ps, 33 + lane - E + TOP, Lb);
    if (MAP) ca = tab[ca];
  } else {
    ai = rows >= 1 ? a_byte<MAP>(a, 0, tab) : 0u;
    nb = byte_at(b, b_ps, 1 - E + TOP, Lb);
  }
  for (int i = 1; i <= rows; ++i) {
    unsigned ai_next = 0u, nb_next = 0u;
    if constexpr (RING) {
      const int k = (i - 1) & 31;
      ai = __shfl_sync(kFull, ca, k);
      nb = __shfl_sync(kFull, cb, k);
      if (k == 31) {            // the chunk's last row: the next one's bytes
        ca = MAP ? tab[na] : na;
        cb = nx;
        na = i + 32 + lane < rows ? a[(i + 32 + lane) * a_ps] : 0u;
        nx = byte_at(b, b_ps, i + 33 + lane - E + TOP, Lb);
      }
    } else {
      ai_next = i < rows ? a_byte<MAP>(a, i * a_ps, tab) : 0u;
      nb_next = byte_at(b, b_ps, i + 1 - E + TOP, Lb);
    }
    const int dlo = E + 1 - i, dhi = min(lb + E - i, w - 1);
    int carry = BIG, rowmin = BIG;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 32 * c + lane;
      int up = __shfl_down_sync(kFull, v[c], 1);
      const int next0 = c + 1 < NC ? __shfl_sync(kFull, v[c + 1], 0) : BIG;
      if (lane == 31) up = next0;
      int x = min(v[c] + (wb[c] != ai ? 1 : 0), up + 1);
      x = (d >= dlo && d <= dhi) ? x : BIG;
      v[c] = min(sweep_chunk(x, lane, carry), BIG);
      rowmin = min(rowmin, v[c]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const unsigned down = __shfl_down_sync(kFull, wb[c], 1);
      const unsigned next0 = c + 1 < NC ? __shfl_sync(kFull, wb[c + 1], 0)
                                        : nb;
      wb[c] = lane == 31 ? next0 : down;
    }
    ai = ai_next;
    nb = nb_next;
    if (__all_sync(kFull, rowmin > E)) return BIG;
  }
  int res = BIG;
  const int df = lb - la + E;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 32 * c + lane;
    if (infix) {
      const int jsf = la - E + d;
      if (d < w && jsf >= 0 && jsf <= lb) res = min(res, v[c]);
    } else if (d == df) {
      res = v[c];
    }
  }
  return warp_min(res);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    banded_warp_kernel(Pairs p) {
  const int lane = threadIdx.x & 31;
  const long long t = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (t >= p.n) return;                       // the whole warp
  const int res = warp_pair<NC>(p.a + t * p.a_pp, p.a_ps, p.la[t * p.la_pp],
                                p.La, p.b + t * p.b_pp, p.b_ps,
                                p.lb[t * p.lb_pp], p.Lb, p.E, p.infix, lane);
  if (lane == 0) p.out[t] = res;
}

// ---------------------------------------------------------------------
// A warp a pair, the band (nc chunks) in a scratch row of device memory
// (band: 32 nc ints of its own), in the layout of warp_pair.
// ---------------------------------------------------------------------
template <bool MAP = false>
__device__ __forceinline__ int warp_mem_pair(const uint8_t* a,
                                             long long a_ps, int la, int La,
                                             const uint8_t* b, long long b_ps,
                                             int lb, int Lb, int E, int infix,
                                             int lane, int* band,
                                             const uint8_t* tab = nullptr) {
  const int w = 2 * E + 1, BIG = E + 1;
  const int nc = (w + 31) / 32, cells = 32 * nc;
  if (!infix && abs(lb - la) > E) return BIG;
  for (int d = lane; d < cells; d += 32) band[d] = row0_cell(d, w, E, lb,
                                                             infix);
  __syncwarp();
  const int rows = min(la, La);
  for (int i = 1; i <= rows; ++i) {
    const unsigned ai = a_byte<MAP>(a, (i - 1) * a_ps, tab);
    const int dlo = E + 1 - i, dhi = min(lb + E - i, w - 1);
    int carry = BIG, rowmin = BIG;
    for (int c = 0; c < nc; ++c) {
      const int d = 32 * c + lane;
      const int pv = band[d];
      const int up = d + 1 < cells ? band[d + 1] : BIG;
      __syncwarp();
      const unsigned bj = byte_at(b, b_ps, i - E - 1 + d, Lb);
      int x = min(pv + (bj != ai ? 1 : 0), up + 1);
      x = (d >= dlo && d <= dhi) ? x : BIG;
      const int vd = min(sweep_chunk(x, lane, carry), BIG);
      band[d] = vd;
      rowmin = min(rowmin, vd);
      __syncwarp();
    }
    if (__all_sync(kFull, rowmin > E)) return BIG;
  }
  int res = BIG;
  const int df = lb - la + E;
  for (int d = lane; d < cells; d += 32) {
    if (infix) {
      const int jsf = la - E + d;
      if (d < w && jsf >= 0 && jsf <= lb) res = min(res, band[d]);
    } else if (d == df) {
      res = band[d];
    }
  }
  return warp_min(res);
}

__global__ void __launch_bounds__(kThreads)
    banded_warp_mem_kernel(Pairs p, int* scratch) {
  const int lane = threadIdx.x & 31;
  const long long t = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (t >= p.n) return;
  const int cells = 32 * ((2 * p.E + 1 + 31) / 32);
  const int res = warp_mem_pair(p.a + t * p.a_pp, p.a_ps, p.la[t * p.la_pp],
                                p.La, p.b + t * p.b_pp, p.b_ps,
                                p.lb[t * p.lb_pp], p.Lb, p.E, p.infix, lane,
                                scratch + t * cells);
  if (lane == 0) p.out[t] = res;
}

// ---------------------------------------------------------------------
// The block mapping: a tile of kTile class sequences x a group of queries.
// ---------------------------------------------------------------------
constexpr int kTile = 128;

struct Block {
  const uint8_t* q;   // queries, byte (pos, i) at q + pos * q_ps + i
  long long q_ps;
  const int* lq;
  int Q, Lq;
  const uint8_t* s;   // class sequences, byte (pos, j) at s + pos * s_ps + j
  long long s_ps;
  const int* ls;
  int k, Ls, E, tri, group;
  uint8_t* out;       // flags (Q,), or the (Q, Q) triangle
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <int W, bool STAGED>
__global__ void __launch_bounds__(kTile) banded_block_kernel(Block p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kTile;
  const int g0 = blockIdx.y * p.group;
  const int ng = min(p.group, p.Q - g0);
  const uint8_t* tile = p.s + j0 + t;
  long long tile_ps = p.s_ps;
  const uint8_t* qs = p.q + g0;
  long long q_ps = p.q_ps;
  if (STAGED) {
    // the tile's rows are 128 bytes at 16-byte aligned addresses (the
    // launcher checks the class's pitch and base)
    uint8_t* st = sm;
    uint8_t* sq = sm + static_cast<size_t>(p.Ls) * kTile;
    for (int idx = t; idx < p.Ls * (kTile / 16); idx += kTile) {
      const int pos = idx / (kTile / 16), piece = idx % (kTile / 16);
      cp_async16(st + pos * kTile + piece * 16,
                 p.s + pos * p.s_ps + j0 + piece * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int idx = t; idx < p.Lq * ng; idx += kTile) {
      const int pos = idx / ng, g = idx - pos * ng;
      sq[pos * p.group + g] = p.q[pos * p.q_ps + g0 + g];
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    tile = st + t;
    tile_ps = kTile;
    qs = sq;
    q_ps = p.group;
  }
  const int j = j0 + t;
  const bool live = j < p.k;
  const int lb = live ? p.ls[j] : 0;
  for (int g = 0; g < ng; ++g) {
    const int i = g0 + g;
    bool hit = false;
    if (live && (!p.tri || j < i))
      hit = thread_pair<W>(qs + g, q_ps, p.lq[i], p.Lq, tile, tile_ps, lb,
                           p.Ls, p.E, 0) <= p.E;
    if (p.tri) {
      if (live && j < i) p.out[static_cast<size_t>(i) * p.Q + j] = hit;
    } else if (__any_sync(kFull, hit) && (t & 31) == 0) {
      p.out[i] = 1;
    }
  }
}

// The block mapping on the four-lane body: a thread four neighbouring
// sequences of a tile of kQuadTile, their bytes at a position one aligned
// word of the position-major class, read in place (the cache serves a
// tile's words to the group's queries: staging the tile in shared memory,
// as the thread body does, ran slower, two blocks an SM against the
// registers' sixteen), against the query's byte shared by the four.
constexpr int kQuadThreads = 128;
constexpr int kQuadTile = 4 * kQuadThreads;

template <int W>
__global__ void __launch_bounds__(kQuadThreads)
    banded_block_quad_kernel(Block p) {
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kQuadTile;
  const int g0 = blockIdx.y * p.group;
  const int ng = min(p.group, p.Q - g0);
  const int j = j0 + 4 * t;
  int lb[4];
  uint32_t seqs = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lb[q] = j + q < p.k ? p.ls[j + q] : 0;
    if (j + q < p.k) seqs |= 0xffu << (8 * q);
  }
  const BWord b{p.s + j, p.s_ps, p.Ls};
  for (int g = 0; g < ng; ++g) {
    const int i = g0 + g;
    uint32_t lanes = seqs;
    if (p.tri) {                           // the lower triangle, j < i
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q >= i) lanes &= ~(0xffu << (8 * q));
    }
    const int l = p.lq[i];
    const int la[4] = {l, l, l, l};
    const uint32_t hits = lanes ? quad_pairs<W, false>(
        AByte{p.q + i, p.q_ps}, b, la, lb, lanes, p.Lq, p.E, 0) & kOnes
                                  : 0u;
    if (p.tri) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (lanes & (0xffu << (8 * q)))
          p.out[static_cast<size_t>(i) * p.Q + j + q] = (hits >> (8 * q)) & 1;
    } else if (__any_sync(kFull, hits != 0) && (t & 31) == 0) {
      p.out[i] = 1;
    }
  }
}

template <int W>
cudaError_t launch_block_quad(const Block& p, cudaStream_t stream) {
  const dim3 grid((p.k + kQuadTile - 1) / kQuadTile,
                  (p.Q + p.group - 1) / p.group);
  banded_block_quad_kernel<W><<<grid, kQuadThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_block(const Block& p, bool staged, size_t smem,
                         cudaStream_t stream) {
  const dim3 grid((p.k + kTile - 1) / kTile,
                  (p.Q + p.group - 1) / p.group);
  if (!staged) {
    banded_block_kernel<W, false><<<grid, kTile, 0, stream>>>(p);
    return cudaGetLastError();
  }
  auto kernel = banded_block_kernel<W, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_thread(const Pairs& p, cudaStream_t stream) {
  const int blocks = (p.n + kThreads - 1) / kThreads;
  banded_thread_kernel<W><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_thread_quad(const Pairs& p, cudaStream_t stream) {
  const int blocks = ((p.n + 3) / 4 + kThreads - 1) / kThreads;
  if (p.a_pp == 0 && p.la_pp == 0)
    banded_thread_quad_kernel<W, false, false><<<blocks, kThreads, 0,
                                                 stream>>>(p);
  else if (p.a_pp == 0)
    banded_thread_quad_kernel<W, false, true><<<blocks, kThreads, 0,
                                                stream>>>(p);
  else if (p.la_pp == 0)
    banded_thread_quad_kernel<W, true, false><<<blocks, kThreads, 0,
                                                stream>>>(p);
  else
    banded_thread_quad_kernel<W, true, true><<<blocks, kThreads, 0,
                                               stream>>>(p);
  return cudaGetLastError();
}

// Pairs whose operands the four-lane body reads a word at a time: b
// pair-minor with a pair stride of 1, a the same or shared (a pair stride of
// 0), rows and bases 4-byte aligned.
bool quad_layout(const Pairs& p) {
  const auto aligned = [](const void* x, long long ps) {
    return reinterpret_cast<uintptr_t>(x) % 4 == 0 && ps % 4 == 0;
  };
  return p.b_pp == 1 && aligned(p.b, p.b_ps) &&
         (p.a_pp == 0 || (p.a_pp == 1 && aligned(p.a, p.a_ps)));
}

template <int NC>
cudaError_t launch_warp(const Pairs& p, cudaStream_t stream) {
  const long long threads = 32LL * p.n;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  banded_warp_kernel<NC><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The containment mapping: a pair table over a block of queries and the
// windows cut for them, both orientations, one flag a query.
// ---------------------------------------------------------------------
struct Contained {
  const uint8_t* q;   // queries, byte (pos, i) at q + pos * q_ps + i
  long long q_ps;
  const int* lq;
  int Lq;
  const uint8_t* w;   // windows, byte (pos, c) at w + pos * w_ps + c
  long long w_ps;
  int Lw;
  const int* table;   // (3, P): query column, window column, window length
  int P, tol;
  uint8_t* flags;     // (Q,), zeroed by the caller
};

// The containment mappings, as the C entry's mapping codes
// (ops/banded_device.CONTAINED_MAPPINGS names them).
enum ContainedMapping : int {
  kContainedInplace = 0,  // a thread (a warp) an orientation, read a row ahead
  kContainedStaged = 1,   // a thread an orientation, operands in shared memory
  kContainedRing = 2,     // a thread an orientation, a ring of bytes
  kContainedWarp = 3,     // a warp an orientation past 64 cells, a lane ring
  kContainedSplit = 4,    // a warp a pair, the rows split over the lanes
};

#ifdef BBMAP_CONTAINED_CLOCKS
// The counting build: each (pair k, orientation rc) run's clocks in its
// band and before it (the tables and, staged, the operands) at
// g_contained_clocks[2 (2k + rc)] and [2 (2k + rc) + 1].
__device__ long long* g_contained_clocks;
#define CONTAINED_CLOCK(name) const long long name = clock64()
#define CONTAINED_RECORD(k, rc, t0, t1)                                 \
  do {                                                                  \
    const long long t2_ = clock64();                                    \
    g_contained_clocks[2 * (2 * (k) + (rc))] = t2_ - (t1);              \
    g_contained_clocks[2 * (2 * (k) + (rc)) + 1] = (t1) - (t0);         \
  } while (0)
#else
#define CONTAINED_CLOCK(name)
#define CONTAINED_RECORD(k, rc, t0, t1)
#endif

// The identity (tab[0, 256)) and the complement (tab[256, 512)), staged by
// the block.
__device__ __forceinline__ void stage_tables(uint8_t* tab) {
  for (int x = threadIdx.x; x < 256; x += blockDim.x) {
    tab[x] = static_cast<uint8_t>(x);
    tab[256 + x] = kComp[x];
  }
  __syncthreads();
}

// Pair k's operands in orientation rc (1: the reverse complement, read from
// the forward column backward): the query's first byte, stride and length.
struct Operand {
  const uint8_t* a;
  long long a_ps;
  int la, col;
};

__device__ __forceinline__ Operand operand(const Contained& p, long long k,
                                           int rc) {
  const int col = p.table[k];
  const int la = p.lq[col];
  const uint8_t* a = p.q + col;
  if (rc && la > 0) a += (la - 1) * p.q_ps;
  return {a, rc ? -p.q_ps : p.q_ps, la, col};
}

// The staged thread body: a block's kStagePairs pairs, the query and the
// window of each in a row of shared memory (pair-major), at most
// kStageMax bytes; a thread loads kStageBatch positions of each before it
// stores them (2 kStageBatch loads in flight).
constexpr int kStagePairs = kThreads / 2;
constexpr int kStageMax = 48 * 1024 - 512;
constexpr int kStageBatch = 16;

// A staged row's pitch: L bytes rounded up to an odd number of words, so
// that the rows of a warp's pairs at one position lie in distinct banks.
__host__ __device__ inline int stage_pitch(int L) {
  return 4 * (((L + 3) / 4) | 1);
}

__host__ __device__ inline int stage_bytes(int Lq, int Lw) {
  return kStagePairs * (stage_pitch(Lq) + stage_pitch(Lw));
}

// The first la bytes of a query column (a position-major, a_ps a
// position) into sa and the first lw of a window (b, b_ps) into sb, one
// byte a position; the block's threads h = 0, 1 of a pair take positions
// h, h + 2, ...
__device__ __forceinline__ void stage_pair(uint8_t* sa, const uint8_t* a,
                                           long long a_ps, int la,
                                           uint8_t* sb, const uint8_t* b,
                                           long long b_ps, int lb, int h) {
  const int n = max(la, lb);
  for (int p0 = h; p0 < n; p0 += 2 * kStageBatch) {
    unsigned xa[kStageBatch], xb[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int pos = p0 + 2 * j;
      xa[j] = pos < la ? __ldg(a + pos * a_ps) : 0u;
      xb[j] = pos < lb ? __ldg(b + pos * b_ps) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int pos = p0 + 2 * j;
      if (pos < la) sa[pos] = static_cast<uint8_t>(xa[j]);
      if (pos < lb) sb[pos] = static_cast<uint8_t>(xb[j]);
    }
  }
}

// The rows of a group of the new thread bodies (thread_pair's K): enough
// for a round trip to device memory between a byte's load and its row (a
// row of 9 cells takes ~100 instructions, one of 64 ~600), and rows for
// the scheduler to overlap, at ~W * 8 cells unrolled.
__host__ __device__ constexpr int ring_depth(int W) {
  return W <= 16 ? 8 : W <= 32 ? 4 : 2;
}

// A thread an orientation of a pair (thread 2p + rc of pair p, so that a
// query's runs sit on neighbouring lanes) on thread_pair in groups of K
// rows: STAGED, the block's pairs' query columns and windows copied to
// shared memory first (a pair's bytes in a row); else read in place, K
// rows ahead (K = 1: the first body, a row at a time, its bytes loaded
// during the row before).
template <int W, bool STAGED, int K>
__global__ void __launch_bounds__(kThreads)
    banded_contained_kernel(Contained p) {
  __shared__ uint8_t tab[512];
  extern __shared__ __align__(16) uint8_t staged[];
  CONTAINED_CLOCK(t_start);
  stage_tables(tab);
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long k = t >> 1;
  const int rc = t & 1;
  const int pq = stage_pitch(p.Lq), pw = stage_pitch(p.Lw);
  if constexpr (STAGED) {
    const int slot = threadIdx.x % kStagePairs;
    const long long ks = blockIdx.x * (long long)kStagePairs + slot;
    if (ks < p.P) {
      const int col = p.table[ks];
      stage_pair(staged + slot * pq, p.q + col, p.q_ps,
                 min(p.lq[col], p.Lq), staged + kStagePairs * pq + slot * pw,
                 p.w + p.table[p.P + ks], p.w_ps,
                 min(p.table[2 * p.P + ks], p.Lw), threadIdx.x / kStagePairs);
    }
    __syncthreads();
  }
  CONTAINED_CLOCK(t_band);
  int col = -1;
  bool hit = false;
  if (k < p.P) {
    const Operand o = operand(p, k, rc);
    col = o.col;
    const int lb = p.table[2 * p.P + k];
    int d;
    if constexpr (STAGED) {
      const int slot = threadIdx.x >> 1;
      const uint8_t* sa = staged + slot * pq;
      d = thread_pair<W, true, K>(rc && o.la > 0 ? sa + o.la - 1 : sa,
                                  rc ? -1 : 1, o.la, p.Lq,
                                  staged + kStagePairs * pq + slot * pw, 1,
                                  lb, p.Lw, 2 * p.tol, 1, tab + 256 * rc);
    } else {
      d = thread_pair<W, true, K>(o.a, o.a_ps, o.la, p.Lq,
                                  p.w + p.table[p.P + k], p.w_ps, lb, p.Lw,
                                  2 * p.tol, 1, tab + 256 * rc);
    }
    hit = d <= p.tol;
    CONTAINED_RECORD(k, rc, t_start, t_band);
  }
  // the lanes of one query vote; the lowest of them stores
  const unsigned peers = __match_any_sync(kFull, col);
  const unsigned hits = __ballot_sync(kFull, hit) & peers;
  if (col >= 0 && hits && static_cast<int>(threadIdx.x & 31) ==
                                 __ffs(peers) - 1)
    p.flags[col] = 1;
}

// A warp an orientation of a pair: NC chunks in registers (RING: a and the
// window's bytes from the lanes' ring), or (NC == 0) the band in scratch,
// 32 * warp_chunks(2 tol) ints a warp.
template <int NC, bool RING>
__global__ void __launch_bounds__(kThreads)
    banded_contained_warp_kernel(Contained p, int* scratch) {
  __shared__ uint8_t tab[512];
  CONTAINED_CLOCK(t_start);
  stage_tables(tab);
  CONTAINED_CLOCK(t_band);
  const int lane = threadIdx.x & 31;
  const long long t = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long k = t >> 1;
  if (k >= p.P) return;                       // the whole warp
  const int rc = t & 1, E = 2 * p.tol;
  const Operand o = operand(p, k, rc);
  const uint8_t* b = p.w + p.table[p.P + k];
  const int lb = p.table[2 * p.P + k];
  int d;
  if constexpr (NC > 0) {
    d = warp_pair<NC, true, RING>(o.a, o.a_ps, o.la, p.Lq, b, p.w_ps, lb,
                                  p.Lw, E, 1, lane, tab + 256 * rc);
  } else {
    d = warp_mem_pair<true>(o.a, o.a_ps, o.la, p.Lq, b, p.w_ps, lb, p.Lw,
                            E, 1, lane, scratch + t * 32 * warp_chunks(E),
                            tab + 256 * rc);
  }
  if (lane == 0) {
    if (d <= p.tol) p.flags[o.col] = 1;
    CONTAINED_RECORD(k, rc, t_start, t_band);
  }
}

// ---------------------------------------------------------------------
// The split mapping (4 tol + 1 <= kSplitMaxCells band cells): a warp a
// pair, a half-warp (kSplitLanes lanes) an orientation, the chain of rows
// split over the lanes. With every value capped at BIG (the band is
// clamped there each row, and every value is >= 0, so an entry >= BIG acts
// as no entry), a row of the band is a min-plus linear map of the band:
// the mismatch, the cell above + 1 and the insertion sweep are its
// entries, a cell outside the row's valid range a row of BIG. Maps
// compose associatively, so lane j composes the map A_j of its run of rows
// (r0 + 1 .. r1, with r0 = rows * j / 16, r1 = rows * (j + 1) / 16) by
// running each row on every column of its map (the identity at first;
// lane 0 starts from row 0's band in every column), a cell's columns four
// to a word in the headroom code of quad_pairs (a value x <= BIG <= 7 as
// (1 << (BIG - x)) - 1 in a byte lane: min is OR, + 1 a shift). The maps
// then meet the final cells from the last lane down: lane 15 takes the
// min of its map over the final cells, column by column (a row vector c),
// and 15 steps hand c one lane down (__shfl_down_sync), each lane taking
// c'[e] = min_d (c[d] + A_j[d][e]), for each d the words of A_j's row d
// shifted down by c[d] in every byte lane, ORed. Lane 0's map holds row
// r1's band in every column, so lane 0's c' is the distance in every
// column. A band that saturates stays BIG under every later map: the
// result is thread_pair's, without its early stop. A lane loads the bytes
// of kSplitChunk rows at once (all in flight, one wait on device memory
// a run) into a queue of words that shifts a byte a row. At dedupe's
// 150 bp a lane runs <= 10 rows and the join 15 steps, where the thread
// body runs up to 150 dependent rows.
// ---------------------------------------------------------------------
constexpr int kSplitLanes = 16;
constexpr int kSplitChunk = 16;
constexpr int kSplitMaxCells = 13;

// x + 1 in each byte lane of a headroom word (0, BIG, stays 0)
__device__ __forceinline__ uint32_t plus1(uint32_t x) {
  return (x >> 1) & kLow7;
}

// One row i of the band run on every column of the map U (row d of the
// map, its columns four to a word), the window's bytes win, a's byte ai.
template <int W>
__device__ __forceinline__ void split_row(uint32_t (&U)[W][(W + 3) / 4],
                                          const uint32_t (&win)[(W + 3) / 4],
                                          unsigned ai, int i, int lb) {
  constexpr int E = (W - 1) / 2, NG = (W + 3) / 4;
  const uint32_t rep = ai * kOnes;
  uint32_t m[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) m[j] = __vcmpne4(win[j], rep);
  const int dlo = E + 1 - i, dhi = min(lb + E - i, W - 1);
  uint32_t r[NG], s[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    r[g] = 0u;
    s[g] = plus1(U[0][g]);
  }
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const uint32_t ne = 0u - ((m[d >> 2] >> (8 * (d & 3))) & 1u);
    const uint32_t ok = (d >= dlo && d <= dhi) ? 0xffffffffu : 0u;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      // s: this cell + 1 (the previous row's), up: the cell above + 1
      const uint32_t up = d + 1 < W ? plus1(U[d + 1][g]) : 0u;
      const uint32_t c = ((U[d][g] & ~ne) | (s[g] & ne) | up) & ok;
      r[g] = c | plus1(r[g]);
      U[d][g] = r[g];
      s[g] = up;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    banded_contained_split_kernel(Contained p) {
  constexpr int E = (W - 1) / 2, BIG = E + 1, NG = (W + 3) / 4;
  constexpr int TOP = 4 * NG - 1;            // the window's last byte
  constexpr int NQ = kSplitChunk / 4;
  constexpr uint32_t kD0 = (1u << BIG) - 1;  // the code of 0
  __shared__ uint8_t tab[512];
  CONTAINED_CLOCK(t_start);
  stage_tables(tab);
  CONTAINED_CLOCK(t_band);
  const int lane = threadIdx.x & 31, seg = lane % kSplitLanes;
  const int rc = lane / kSplitLanes;
  const long long k = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (k >= p.P) return;                       // the whole warp
  const Operand o = operand(p, k, rc);
  const uint8_t* tb = tab + 256 * rc;
  const uint8_t* b = p.w + p.table[p.P + k];
  const int lb = p.table[2 * p.P + k];
  const int rows = min(o.la, p.Lq);
  const int r0 = seg * rows / kSplitLanes;
  const int r1 = (seg + 1) * rows / kSplitLanes;
  uint32_t U[W][NG];
#pragma unroll
  for (int d = 0; d < W; ++d)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      U[d][g] = seg == 0
          ? (row0_cell(d, W, E, lb, 1) == 0 ? kD0 * kOnes : 0u)
          : (d >> 2 == g ? kD0 << (8 * (d & 3)) : 0u);
  // byte d of the window at row i is b[i - E - 1 + d]; here i = r0 + 1
  uint32_t win[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    uint32_t x = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x |= byte_at(b, p.w_ps, r0 + 4 * j + q - E, p.Lw) << (8 * q);
    win[j] = x;
  }
  for (int i0 = r0 + 1; i0 <= r1; i0 += kSplitChunk) {
    // the run's a[i - 1] (through tb) and the bytes that enter the window
    // after row i, loaded together, four rows to a word
    unsigned xa[kSplitChunk], xb[kSplitChunk];
#pragma unroll
    for (int j = 0; j < kSplitChunk; ++j) {
      const int i = i0 + j;
      xa[j] = i <= r1 ? o.a[(i - 1) * o.a_ps] : 0u;
      xb[j] = i <= r1 ? byte_at(b, p.w_ps, i - E + TOP, p.Lw) : 0u;
    }
    uint32_t qa[NQ], qb[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      qa[j] = 0u;
      qb[j] = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        qa[j] |= static_cast<uint32_t>(tb[xa[4 * j + q]]) << (8 * q);
        qb[j] |= xb[4 * j + q] << (8 * q);
      }
    }
    const int end = min(r1, i0 + kSplitChunk - 1);
    for (int i = i0; i <= end; ++i) {
      split_row<W>(U, win, qa[0] & 0xffu, i, lb);
#pragma unroll
      for (int j = 0; j + 1 < NG; ++j)
        win[j] = __funnelshift_r(win[j], win[j + 1], 8);
      win[NG - 1] = (win[NG - 1] >> 8) | ((qb[0] & 0xffu) << 24);
#pragma unroll
      for (int j = 0; j + 1 < NQ; ++j) {
        qa[j] = __funnelshift_r(qa[j], qa[j + 1], 8);
        qb[j] = __funnelshift_r(qb[j], qb[j + 1], 8);
      }
      qa[NQ - 1] >>= 8;
      qb[NQ - 1] >>= 8;
    }
  }
  // c: the map's min over the final cells (la - E + d in [0, lb]), column
  // by column; then down the lanes
  uint32_t c[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) c[g] = 0u;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const int jsf = o.la - E + d;
    if (jsf >= 0 && jsf <= lb) {
#pragma unroll
      for (int g = 0; g < NG; ++g) c[g] |= U[d][g];
    }
  }
  for (int step = 1; step < kSplitLanes; ++step) {
    uint32_t in[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      in[g] = __shfl_down_sync(kFull, c[g], 1, kSplitLanes);
      c[g] = 0u;
    }
#pragma unroll
    for (int d = 0; d < W; ++d) {
      const int x = BIG - __popc((in[d >> 2] >> (8 * (d & 3))) & 0xffu);
      const uint32_t keep = (0xffu >> x) * kOnes;
#pragma unroll
      for (int g = 0; g < NG; ++g) c[g] |= (U[d][g] >> x) & keep;
    }
  }
  const int dist = BIG - __popc(c[0] & 0xffu);
  const unsigned hits = __ballot_sync(kFull, seg == 0 && dist <= p.tol);
  if (lane == 0 && hits) p.flags[o.col] = 1;
  if (seg == 0) CONTAINED_RECORD(k, rc, t_start, t_band);
}

template <int W>
cudaError_t launch_contained(const Contained& p, int mapping,
                             cudaStream_t stream) {
  const long long threads = 2LL * p.P;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (mapping == kContainedStaged)
    banded_contained_kernel<W, true, ring_depth(W)><<<
        blocks, kThreads, stage_bytes(p.Lq, p.Lw), stream>>>(p);
  else if (mapping == kContainedRing)
    banded_contained_kernel<W, false, ring_depth(W)><<<blocks, kThreads, 0,
                                                      stream>>>(p);
  else
    banded_contained_kernel<W, false, 1><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_contained_warp(const Contained& p, bool ring,
                                  int* scratch, cudaStream_t stream) {
  const long long threads = 64LL * p.P;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if constexpr (NC > 0) {
    if (ring) {
      banded_contained_warp_kernel<NC, true><<<blocks, kThreads, 0, stream>>>(
          p, scratch);
      return cudaGetLastError();
    }
  }
  banded_contained_warp_kernel<NC, false><<<blocks, kThreads, 0, stream>>>(
      p, scratch);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_contained_split(const Contained& p, cudaStream_t stream) {
  const long long threads = 32LL * p.P;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  banded_contained_split_kernel<W><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of device scratch a pair needs in the warp mapping at this E: 0
// while the band fits the registers (2E + 1 <= 1,024 cells).
long long banded_edit_scratch_ints(int E) {
  const int nc = warp_chunks(E);
  return nc <= kWarpRegChunks ? 0 : 32LL * nc;
}

// The widest band the thread mapping holds: the launcher takes a thread a
// pair up to it and a warp a pair past it.
int banded_edit_thread_max_cells() { return kThreadMaxCells; }

// The widest band the four-lane body holds (E <= 7).
int banded_edit_quad_max_cells() { return kQuadMaxCells; }

// n pairs; a byte (pos, pair) at a + pos * a_ps + pair * a_pp (La
// positions), b likewise (Lb positions), la / lb int32 at pair * stride.
// scratch holds n * banded_edit_scratch_ints(E) ints where that is > 0.
// out (n,) int32, saturated at E + 1. quad: four pairs a thread on the
// four-lane body (2E + 1 <= 15, b pair-minor with a pair stride of 1, a
// the same or shared, rows and bases 4-byte aligned, and each row's bytes
// up to n rounded up to 4 readable), else a thread a pair to 64 cells, a
// warp a pair past that.
cudaError_t banded_edit_launch(const uint8_t* a, long long a_ps,
                               long long a_pp, const int* la,
                               long long la_pp, const uint8_t* b,
                               long long b_ps, long long b_pp, const int* lb,
                               long long lb_pp, int n, int La, int Lb, int E,
                               int infix, int quad, int* out, int* scratch,
                               cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (E < 0 || La < 0 || Lb < 0) return cudaErrorInvalidValue;
  const Pairs p{a, a_ps, a_pp, la, la_pp, b, b_ps, b_pp, lb, lb_pp,
                n, La, Lb, E, infix ? 1 : 0, out};
  const int w = 2 * E + 1;
  if (quad) {
    if (w > kQuadMaxCells || !quad_layout(p)) return cudaErrorInvalidValue;
    switch (w) {
      case 1: return launch_thread_quad<1>(p, stream);
      case 3: return launch_thread_quad<3>(p, stream);
      case 5: return launch_thread_quad<5>(p, stream);
      case 7: return launch_thread_quad<7>(p, stream);
      case 9: return launch_thread_quad<9>(p, stream);
      case 11: return launch_thread_quad<11>(p, stream);
      case 13: return launch_thread_quad<13>(p, stream);
      default: return launch_thread_quad<15>(p, stream);
    }
  }
  if (w <= kThreadMaxCells) {
    switch (w) {
      case 1: return launch_thread<1>(p, stream);
      case 3: return launch_thread<3>(p, stream);
      case 5: return launch_thread<5>(p, stream);
      case 7: return launch_thread<7>(p, stream);
      case 9: return launch_thread<9>(p, stream);
      case 11: return launch_thread<11>(p, stream);
      case 13: return launch_thread<13>(p, stream);
      case 15: return launch_thread<15>(p, stream);
      default: break;
    }
    if (w <= 32) return launch_thread<32>(p, stream);
    return launch_thread<64>(p, stream);
  }
  // w > 64: 3 chunks or more
  const int nc = warp_chunks(E);
  if (nc <= 3) return launch_warp<3>(p, stream);
  if (nc <= 4) return launch_warp<4>(p, stream);
  if (nc <= 6) return launch_warp<6>(p, stream);
  if (nc <= 8) return launch_warp<8>(p, stream);
  if (nc <= 12) return launch_warp<12>(p, stream);
  if (nc <= 16) return launch_warp<16>(p, stream);
  if (nc <= 24) return launch_warp<24>(p, stream);
  if (nc <= kWarpRegChunks) return launch_warp<32>(p, stream);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const long long threads = 32LL * n;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  banded_warp_mem_kernel<<<blocks, kThreads, 0, stream>>>(p, scratch);
  return cudaGetLastError();
}

// The block mapping. Queries: byte (pos, i) at q + pos * q_ps + i, Q of
// them, Lq positions, lengths lq (Q,). tri == 0: the class's k sequences,
// byte (pos, j) at s + pos * s_ps + j, Ls positions, lengths ls (k,); out
// (Q,) flags, which the caller zeroes, set to 1 where any sequence lies
// within E. tri == 1: s, s_ps, ls, k and Ls are the queries' own; out (Q,
// Q), the caller zeroes it, row i column j < i = d(query i, query j) <= E.
// group: queries a block. staged: copy the tile and the group into shared
// memory (s_ps a multiple of 16 and at least k rounded up to 128, s 16-byte
// aligned), else read them in place. 2E + 1 <= 64. quad: the four-lane body
// instead, a tile of kQuadTile sequences a block read in place (staged is
// not taken): 2E + 1 <= 15, s_ps a multiple of 4, s 4-byte aligned and
// each row's bytes up to k rounded up to 4 readable.
int banded_block_smem(int Ls, int Lq, int group) {
  return Ls * kTile + Lq * group;
}

// The sequences a block of the block mapping takes.
int banded_block_tile(int quad) { return quad ? kQuadTile : kTile; }

cudaError_t banded_block_launch(const uint8_t* q, long long q_ps,
                                const int* lq, int Q, int Lq,
                                const uint8_t* s, long long s_ps,
                                const int* ls, int k, int Ls, int E, int tri,
                                int group, int staged, int quad,
                                uint8_t* out, cudaStream_t stream) {
  if (Q <= 0 || k <= 0) return cudaSuccess;
  const int w = 2 * E + 1;
  if (E < 0 || w > (quad ? kQuadMaxCells : kThreadMaxCells) || group <= 0 ||
      Lq < 0 || Ls < 0)
    return cudaErrorInvalidValue;
  const Block p{q, q_ps, lq, Q, Lq, s, s_ps, ls, k, Ls, E, tri ? 1 : 0,
                group, out};
  if (quad) {
    if (s_ps % 4 != 0 || reinterpret_cast<uintptr_t>(s) % 4 != 0)
      return cudaErrorInvalidValue;
    switch (w) {
      case 1: return launch_block_quad<1>(p, stream);
      case 3: return launch_block_quad<3>(p, stream);
      case 5: return launch_block_quad<5>(p, stream);
      case 7: return launch_block_quad<7>(p, stream);
      case 9: return launch_block_quad<9>(p, stream);
      case 11: return launch_block_quad<11>(p, stream);
      case 13: return launch_block_quad<13>(p, stream);
      default: return launch_block_quad<15>(p, stream);
    }
  }
  const size_t smem = staged ? static_cast<size_t>(
      banded_block_smem(Ls, Lq, group)) : 0;
  if (staged && (s_ps % 16 != 0 || s_ps < (k + kTile - 1) / kTile * kTile ||
                 reinterpret_cast<uintptr_t>(s) % 16 != 0 ||
                 smem > 232448))
    return cudaErrorInvalidValue;
  const bool st = staged != 0;
  switch (w) {
    case 1: return launch_block<1>(p, st, smem, stream);
    case 3: return launch_block<3>(p, st, smem, stream);
    case 5: return launch_block<5>(p, st, smem, stream);
    case 7: return launch_block<7>(p, st, smem, stream);
    case 9: return launch_block<9>(p, st, smem, stream);
    case 11: return launch_block<11>(p, st, smem, stream);
    case 13: return launch_block<13>(p, st, smem, stream);
    case 15: return launch_block<15>(p, st, smem, stream);
    default: break;
  }
  if (w <= 32) return launch_block<32>(p, st, smem, stream);
  return launch_block<64>(p, st, smem, stream);
}


// The containment mapping. Queries: byte (pos, i) at q + pos * q_ps + i
// (Lq positions), lengths lq (i) <= Lq, read forward and as their reverse
// complement. Windows: byte (pos, c) at w + pos * w_ps + c (Lw positions).
// table (3, P) int32: pair k is query table[k] against window table[P + k]
// of length table[2P + k]. flags (Q,), which the caller zeroes: set to 1
// where, for some pair of the query, the infix distance at E = 2 tol of
// the query or of its reverse complement is <= tol. mapping (a
// ContainedMapping; the caller picks it, banded_device.contained_mapping):
// 4 "split" where 4 tol + 1 <= kSplitMaxCells, 1 "staged" where 4 tol + 1
// <= 64 and stage_bytes(Lq, Lw) <= kStageMax, 2 "ring"
// where 4 tol + 1 <= 64, 3 "warp" past 64 cells, 0 "inplace" everywhere;
// another is refused (cudaErrorInvalidValue). Past 32 chunks (tol >= 256)
// "warp" and "inplace" keep the band in scratch, 2P *
// banded_edit_scratch_ints(2 tol) ints.
cudaError_t banded_contained_launch(const uint8_t* q, long long q_ps,
                                    const int* lq, int Lq, const uint8_t* w,
                                    long long w_ps, int Lw, const int* table,
                                    int P, int tol, int mapping,
                                    uint8_t* flags, int* scratch,
                                    cudaStream_t stream) {
  if (P <= 0) return cudaSuccess;
  if (tol < 0 || Lq < 0 || Lw < 0) return cudaErrorInvalidValue;
  const Contained p{q, q_ps, lq, Lq, w, w_ps, Lw, table, P, tol, flags};
  const int E = 2 * tol, cells = 2 * E + 1;
  switch (mapping) {
    case kContainedSplit:
      switch (cells) {
        case 1: return launch_contained_split<1>(p, stream);
        case 5: return launch_contained_split<5>(p, stream);
        case 9: return launch_contained_split<9>(p, stream);
        case 13: return launch_contained_split<13>(p, stream);
        default: return cudaErrorInvalidValue;
      }
    case kContainedStaged:
      if (stage_bytes(Lq, Lw) > kStageMax) return cudaErrorInvalidValue;
      [[fallthrough]];
    case kContainedRing:
      if (cells > kThreadMaxCells) return cudaErrorInvalidValue;
      break;
    case kContainedWarp:
      if (cells <= kThreadMaxCells) return cudaErrorInvalidValue;
      break;
    case kContainedInplace:
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (cells <= kThreadMaxCells) {
    switch (cells) {
      case 1: return launch_contained<1>(p, mapping, stream);
      case 5: return launch_contained<5>(p, mapping, stream);
      case 9: return launch_contained<9>(p, mapping, stream);
      case 13: return launch_contained<13>(p, mapping, stream);
      default: break;
    }
    if (cells <= 32) return launch_contained<32>(p, mapping, stream);
    return launch_contained<64>(p, mapping, stream);
  }
  const bool ring = mapping == kContainedWarp;
  const int nc = warp_chunks(E);
  if (nc <= 3) return launch_contained_warp<3>(p, ring, scratch, stream);
  if (nc <= 4) return launch_contained_warp<4>(p, ring, scratch, stream);
  if (nc <= 6) return launch_contained_warp<6>(p, ring, scratch, stream);
  if (nc <= 8) return launch_contained_warp<8>(p, ring, scratch, stream);
  if (nc <= 12) return launch_contained_warp<12>(p, ring, scratch, stream);
  if (nc <= 16) return launch_contained_warp<16>(p, ring, scratch, stream);
  if (nc <= 24) return launch_contained_warp<24>(p, ring, scratch, stream);
  if (nc <= kWarpRegChunks)
    return launch_contained_warp<32>(p, ring, scratch, stream);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch_contained_warp<0>(p, ring, scratch, stream);
}

// The counting build (BBMAP_CONTAINED_CLOCKS): the containment kernels
// write each run's clocks (band, before the band) to out, 4P long longs
// (2 (2k + rc) and 2 (2k + rc) + 1); out stays until the next call.
// Elsewhere cudaErrorNotSupported.
cudaError_t banded_contained_clocks(long long* out) {
#ifdef BBMAP_CONTAINED_CLOCKS
  return cudaMemcpyToSymbol(g_contained_clocks, &out, sizeof(out));
#else
  (void)out;
  return cudaErrorNotSupported;
#endif
}

}  // extern "C"
