// K3: the streaming reduction, out[c] = fold over r of f(A)[r, c].
//
// Replaces the Pallas kernel strided_tpu/core/kernels_special.py::
// _make_stream_reduce_kernel (driven by _stream_reduce_2d): a partial
// reduction of a dense operand whose reduced axes are the leading physical
// block, seen as an (N, M) matrix with the kept axes as its minor dim M.
// The fold is sum, prod, min or max; f is an elementwise program
// (ewise.cuh) applied to each element before the fold.
//
// What bounds it on an H100: bytes. The kernel reads N * M elements once
// and writes M; at 8192^2 f32 that is 268 MB against 3.35 TB/s.
//
// Design: a block owns 32 lanes of columns (4 adjacent columns a lane, read
// as one 16-byte load, for 4-byte types with M % 4 == 0; else 1) and
// splits its rows over 8 warps, four rows in flight per thread. Where too few column blocks would fill the 132 SMs the
// rows are also cut into a fixed number of chunks (gridDim.y) whose partials
// go to a scratch buffer, and a second pass folds them in chunk order. Every
// fold runs in a fixed order, so the result is deterministic; there are no
// atomics. Any N and M (masked). Accumulates in f32 for f32/bf16 values and
// in int32 for int32, and rounds once to the result type.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ewise.cuh"

namespace {

constexpr int COLS = 32;
constexpr int LANES = 8;  // row lanes per block (blockDim.y)
constexpr int UNROLL = 4;

__device__ __forceinline__ EwVal eval1(const EwProgram& p, EwVal x) {
  if (p.n_instr == 0) return x;  // identity: no register file
  EwVal r[EW_MAX_REG];
  r[0] = x;
  return ew_run_call(p, r);
}

// V adjacent columns a thread: V = 4 loads 16 bytes at once (4-byte types,
// M % 4 == 0, a 16-byte aligned base), so a warp reads 512 contiguous bytes.
template <int V>
__device__ __forceinline__ void load_row(const void* in, int64_t idx, int t, EwVal* x) {
  if (V == 4) {
    const int4 q = __ldg((const int4*)((const int32_t*)in + idx));
    x[0].i = q.x; x[1].i = q.y; x[2].i = q.z; x[3].i = q.w;
  } else {
    x[0] = ew_load(in, idx, t);
  }
}

template <int V>
__global__ void __launch_bounds__(COLS * LANES)
stream_reduce_kernel(const void* __restrict__ in, void* __restrict__ out,
                     EwVal* __restrict__ scratch, int64_t N, int64_t M, int64_t rows_per_chunk,
                     int red, const __grid_constant__ EwProgram prog) {
  __shared__ EwVal part[LANES][COLS * V];
  const int t = prog.out_type;
  const int in_t = prog.in_type[0];
  const int64_t col = ((int64_t)blockIdx.x * COLS + threadIdx.x) * V;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < N ? r0 + rows_per_chunk : N;
  EwVal acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = ew_red_identity(red, t);
  if (col < M) {
    int64_t r = r0 + threadIdx.y;
    for (; r + (UNROLL - 1) * LANES < r1; r += UNROLL * LANES) {
      EwVal x[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_row<V>(in, (r + u * LANES) * M + col, in_t, x[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = ew_red_fold(red, t, acc[v], eval1(prog, x[u][v]));
    }
    for (; r < r1; r += LANES) {
      EwVal x[V];
      load_row<V>(in, r * M + col, in_t, x);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = ew_red_fold(red, t, acc[v], eval1(prog, x[v]));
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) part[threadIdx.y][threadIdx.x * V + v] = acc[v];
  __syncthreads();
  if (threadIdx.y != 0 || col >= M) return;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    EwVal a = acc[v];
    for (int l = 1; l < LANES; ++l) a = ew_red_merge(red, t, a, part[l][threadIdx.x * V + v]);
    if (gridDim.y == 1) ew_store(out, col + v, t, a);
    else scratch[(int64_t)blockIdx.y * M + col + v] = a;
  }
}

__global__ void merge_chunks_kernel(const EwVal* __restrict__ scratch, void* __restrict__ out,
                                    int64_t M, int chunks, int red, int t) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= M) return;
  EwVal acc = scratch[col];
  for (int c = 1; c < chunks; ++c) acc = ew_red_merge(red, t, acc, scratch[(int64_t)c * M + col]);
  ew_store(out, col, t, acc);
}

}  // namespace

// in: (N, M) dense, of the program's leaf type; out: (M,) of its result
// type; scratch: chunks * M 4-byte values when chunks > 1.
extern "C" int strided_stream_reduce(const void* in, void* out, void* scratch, int64_t N,
                                     int64_t M, int chunks, int vec, int red,
                                     const EwProgram* prog, void* stream) {
  if (N < 1 || M < 1 || chunks < 1 || chunks > 65535 || (vec != 1 && vec != 4) ||
      (vec == 4 && (M % 4 != 0 || prog->in_type[0] == EW_BF16 || ((uintptr_t)in & 15))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows_per_chunk = (N + chunks - 1) / chunks;
  const int64_t cols_per_block = (int64_t)COLS * vec;
  dim3 grid((unsigned)((M + cols_per_block - 1) / cols_per_block), chunks), block(COLS, LANES);
  if (vec == 4)
    stream_reduce_kernel<4><<<grid, block, 0, s>>>(in, out, (EwVal*)scratch, N, M,
                                                   rows_per_chunk, red, *prog);
  else
    stream_reduce_kernel<1><<<grid, block, 0, s>>>(in, out, (EwVal*)scratch, N, M,
                                                   rows_per_chunk, red, *prog);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  merge_chunks_kernel<<<(unsigned)((M + 255) / 256), 256, 0, s>>>(
      (const EwVal*)scratch, out, M, chunks, red, prog->out_type);
  return (int)cudaGetLastError();
}
