// Traceback walk over the fill kernel's prev codes, one launch a batch.
//
// Replaces the device walk of the JAX package, _walk_device
// (bbmap_tpu/ops/msa_jax.py:451, a compiled lax.scan inside the fused
// program); the port ran it as a Python loop of tensor steps, about 35
// launches a step. Same function: start at row R, column col0[b], state
// st0[b]; a step at (row, col) with row > 0 and col > 0 reads the byte of
// cell (row, col), emits m / S / N (state MS), D or - (DEL) or I or Y
// (INS), counts
// the '-' symbols, moves to the predecessor and takes its state from the
// code; with col <= 0 it emits X and moves up and left. The walk stops at
// row 0 or after `steps` symbols; row_end > 0 marks a walk that was cut.
// Symbols are written in walk order (the reverse of the match string) to
// syms (B, steps), zero after the last one, as the plain version lays
// them out; out_len is their count.
//
// Both fill layouts are affine in (row, col), so the walk takes a base
// offset and two strides: cell (row, col) of job b is byte b * job_stride
// + base + row * row_stride + col * col_stride. The wave-major block
// (R+C, R+1) of the short mappings, byte (row + col - 1, row), is base
// -(R+1), strides (R+2, R+1); the row-major block (R+1, pitch) of the band
// mapping is base 0, strides (pitch, 1).
//
// What bounds it: latency. A job's walk is a chain of dependent byte
// loads (the next address needs the state read from this byte), at most
// R + C of them, each a miss to L2 or device memory. Nothing is shared
// between jobs, so the design is the simple one: a warp a job, lane 0
// walks, and the 32 lanes together zero the tail of the symbol row. With
// thousands of jobs a batch every SM holds many chains in flight; a
// long-read fill chunk has few jobs and 12,000 steps, and there the one
// launch costs about what the chain's latency adds up to. All offsets
// are 64-bit: a 56-job long-read block passes 2**31 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int MODE_MS = 0, MODE_DEL = 1, MODE_INS = 2;
constexpr int GAPC = '-';

__device__ __forceinline__ bool defined_base(int c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == 'U';
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msa_walk_kernel(const uint8_t* __restrict__ prevs,
                const uint8_t* __restrict__ reads,
                const uint8_t* __restrict__ refs,
                const int* __restrict__ col0, const int* __restrict__ st0,
                int B, int R, int C, int steps, long long job_stride,
                long long base, long long row_stride, long long col_stride,
                uint8_t* __restrict__ syms,
                int* __restrict__ out_len, int* __restrict__ gaps_out,
                int* __restrict__ row_end) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  uint8_t* sym_row = syms + static_cast<size_t>(b) * steps;
  int n = 0;
  if (lane == 0) {
    const uint8_t* pv = prevs + b * job_stride + base;
    const uint8_t* read = reads + static_cast<size_t>(b) * R;
    const uint8_t* ref = refs + static_cast<size_t>(b) * C;
    int row = R, col = col0[b], st = st0[b], gaps = 0;
    for (; n < steps && row > 0; ++n) {
      int sym;
      if (col > 0) {
        const int code = pv[row * row_stride + min(col, C) * col_stride];
        const int prev = (code >> (2 * st)) & 3;
        const int c_ = read[row - 1];
        const int r_ = ref[min(col - 1, C - 1)];
        if (st == MODE_MS) {
          sym = c_ == r_ ? 'm'
                         : (defined_base(c_) && defined_base(r_) ? 'S' : 'N');
          --row;
          --col;
        } else if (st == MODE_DEL) {
          const bool is_gap = r_ == GAPC;
          sym = is_gap ? '-' : 'D';
          gaps += is_gap;
          --col;
        } else {
          sym = col >= C ? 'Y' : 'I';
          --row;
        }
        st = prev;
      } else {
        sym = 'X';
        --row;
        --col;
      }
      sym_row[n] = static_cast<uint8_t>(sym);
    }
    out_len[b] = n;
    gaps_out[b] = gaps;
    row_end[b] = row;
  }
  n = __shfl_sync(0xffffffffu, n, 0);
  for (int i = n + lane; i < steps; i += 32) sym_row[i] = 0;
}

}  // namespace

extern "C" {

// prevs (B, job_stride) uint8 in the layout (base, row_stride, col_stride),
// reads (B, R) uint8, refs (B, C) uint8, col0 and st0 (B,) int32; syms
// (B, steps) uint8, out_len / gaps / row_end (B,) int32. steps >= 1. The
// wrapper checks that cells (1..R, 1..C) lie inside a job's block.
cudaError_t msa_walk_launch(const uint8_t* prevs, const uint8_t* reads,
                            const uint8_t* refs, const int* col0,
                            const int* st0, int B, int R, int C, int steps,
                            long long job_stride, long long base,
                            long long row_stride, long long col_stride,
                            uint8_t* syms, int* out_len, int* gaps,
                            int* row_end, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (R < 1 || C < 1 || steps < 1) return cudaErrorInvalidValue;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msa_walk_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      prevs, reads, refs, col0, st0, B, R, C, steps, job_stride, base,
      row_stride, col_stride, syms, out_len, gaps, row_end);
  return cudaGetLastError();
}

}  // extern "C"
