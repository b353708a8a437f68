// Traceback walk over the fill kernel's prev codes, one launch a batch.
//
// Replaces the device walk of the JAX package, _walk_device
// (bbmap_tpu/ops/msa_jax.py:451, a compiled lax.scan inside the fused
// program); the port ran it as a Python loop of tensor steps, about 35
// launches a step. Same function, walk_job in msa_dp.cuh: start at row R,
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
// What bounds it: latency. A job's walk is a chain of dependent byte
// loads (the next address needs the state read from this byte), at most
// R + C of them, each a miss to L2 or device memory. Nothing is shared
// between jobs, so the design is the simple one: a warp a job, lane 0
// walks, and the 32 lanes together zero the tail of the symbol row. With
// thousands of jobs a batch every SM holds many chains in flight; a
// long-read fill chunk has few jobs and 12,000 steps, and there the one
// launch costs about what the chain's latency adds up to. All offsets
// are 64-bit: a 56-job long-read block passes 2**31 bytes.

#include "msa_dp.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// A block of prev codes in device memory, affine in (row, col).
struct StridedCodes {
  const uint8_t* pv;
  long long row_stride, col_stride;
  __device__ int operator()(int row, int col) const {
    return pv[row * row_stride + col * col_stride];
  }
};

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
    const WalkEnd e = walk_job(
        StridedCodes{prevs + b * job_stride + base, row_stride, col_stride},
        reads + static_cast<size_t>(b) * R, refs + static_cast<size_t>(b) * C,
        R, C, col0[b], st0[b], steps, sym_row);
    out_len[b] = n = e.n;
    gaps_out[b] = e.gaps;
    row_end[b] = e.row;
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
