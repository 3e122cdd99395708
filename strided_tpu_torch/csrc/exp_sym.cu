// P1: the transpose and symmetrize probe kernels, for square n x n f32.
//
// Replaces the Pallas kernels of benchmarks/exp_sym.py, the TPU round's
// measurement of the ceilings the tile-pair kernel K2 is judged by:
//   transpose_tiles  v_pallas_t2d / v_pallas_t2d_rect: out = A^T, one
//                    TH x TW input tile a block (square or rectangular);
//   sym_two_read     v_pallas_sym_blockspec: out = (A + A^T) * 0.5, one output
//                    tile a block, reading A[i,j] and A[j,i] (three passes
//                    over device memory);
//   pair_tiles       v_pair / _pair_kernel: one block per upper-triangle tile
//                    pair (i <= j) from a worklist; with DO_T it writes
//                    S = (A[i,j] + A[j,i]^T) * 0.5 and S^T (two passes), without
//                    it copies both tiles back (out = A: the schedule's copy
//                    ceiling); SKIP_DIAG writes a diagonal pair's tile once.
//
// What bounds them on an H100: bytes (8 per element for the two-pass
// kernels, 12 for sym_two_read) against 3.35 TB/s; the arithmetic is one add
// and one multiply. The TPU kernels' manual double-buffered DMA and semaphores
// become many blocks in flight; each transposed access goes through shared
// memory padded by one column, so both the row reads and the row writes are
// coalesced and the column reads of the tile hit 32 different banks.
//
// Loops of constant trip count (probe_tiles.cuh) let each thread issue all
// its loads before its first store to shared memory.
//
// Arithmetic: __fadd_rn / __fmul_rn (no contraction), so every output equals
// the plain PyTorch version, (a + a.T) * 0.5, a.T or a, bit for bit. n must be
// a multiple of the tile, as in the TPU probes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_tiles.cuh"

namespace {

using probe::for_tile;
using probe::sym;
using probe::TX;
using probe::TY;

// s[r][c] = X[row0 + r][col0 + c] for an R x C tile.
template <int R, int C>
__device__ __forceinline__ void load(float (*s)[C + 1], const float* __restrict__ x, int n,
                                     int row0, int col0) {
  for_tile<R, C>([&](int r, int c) { s[r][c] = x[(int64_t)(row0 + r) * n + col0 + c]; });
}

template <int TH, int TW>
__global__ void __launch_bounds__(TX * TY)
transpose_tiles_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  __shared__ float s[TH][TW + 1];
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * TW;
  load<TH, TW>(s, a, n, row0, col0);
  __syncthreads();
  for_tile<TW, TH>([&](int c, int r) { out[(int64_t)(col0 + c) * n + row0 + r] = s[r][c]; });
}

template <int T>
__global__ void __launch_bounds__(TX * TY)
sym_two_read_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  __shared__ float s[T][T + 1];
  const int i = blockIdx.y, j = blockIdx.x;
  load<T, T>(s, a, n, j * T, i * T);  // the mirror tile A[j, i]
  __syncthreads();
  for_tile<T, T>([&](int r, int c) {
    const int64_t k = (int64_t)(i * T + r) * n + j * T + c;
    out[k] = sym(a[k], s[c][r]);
  });
}

template <int T, bool DO_T, bool SKIP_DIAG>
__global__ void __launch_bounds__(TX * TY)
pair_tiles_kernel(const float* __restrict__ a, float* __restrict__ out,
                  const int* __restrict__ ii, const int* __restrict__ jj, int n) {
  __shared__ float s0[T][T + 1], s1[T][T + 1];
  const int i = ii[blockIdx.x], j = jj[blockIdx.x];
  load<T, T>(s0, a, n, i * T, j * T);
  load<T, T>(s1, a, n, j * T, i * T);
  __syncthreads();
  const bool second = !(SKIP_DIAG && i == j);
  // out[i,j] = S, S[r][c] = (s0[r][c] + s1[c][r]) / 2; out[j,i] = S^T
  for_tile<T, T>([&](int r, int c) {
    out[(int64_t)(i * T + r) * n + j * T + c] = DO_T ? sym(s0[r][c], s1[c][r]) : s0[r][c];
    if (second)
      out[(int64_t)(j * T + r) * n + i * T + c] = DO_T ? sym(s0[c][r], s1[r][c]) : s1[r][c];
  });
}

inline bool fits(int n, int tile) { return n > 0 && n % tile == 0 && n / tile <= 65535; }

template <int TH, int TW>
cudaError_t transpose_launch(const void* a, void* out, int n, cudaStream_t s) {
  if (!fits(n, TH) || !fits(n, TW)) return cudaErrorInvalidValue;
  transpose_tiles_kernel<TH, TW><<<dim3(n / TW, n / TH), dim3(TX, TY), 0, s>>>(
      (const float*)a, (float*)out, n);
  return cudaGetLastError();
}

template <int T>
cudaError_t sym_launch(const void* a, void* out, int n, cudaStream_t s) {
  if (!fits(n, T)) return cudaErrorInvalidValue;
  sym_two_read_kernel<T><<<dim3(n / T, n / T), dim3(TX, TY), 0, s>>>((const float*)a,
                                                                     (float*)out, n);
  return cudaGetLastError();
}

template <int T>
cudaError_t pair_launch(const void* a, void* out, const void* ii, const void* jj, int npairs,
                        int n, int do_t, int skip_diag, cudaStream_t s) {
  const int nb = n / T;
  if (!fits(n, T) || npairs != nb * (nb + 1) / 2) return cudaErrorInvalidValue;
  const float* x = (const float*)a;
  float* y = (float*)out;
  const int *pi = (const int*)ii, *pj = (const int*)jj;
  const dim3 grid(npairs), block(TX, TY);
  if (do_t && skip_diag) pair_tiles_kernel<T, true, true><<<grid, block, 0, s>>>(x, y, pi, pj, n);
  else if (do_t) pair_tiles_kernel<T, true, false><<<grid, block, 0, s>>>(x, y, pi, pj, n);
  else if (skip_diag) pair_tiles_kernel<T, false, true><<<grid, block, 0, s>>>(x, y, pi, pj, n);
  else pair_tiles_kernel<T, false, false><<<grid, block, 0, s>>>(x, y, pi, pj, n);
  return cudaGetLastError();
}

}  // namespace

// Tile shapes: (32, 32), (64, 64), (32, 64), (64, 32), (32, 128), (128, 32).
extern "C" int strided_transpose_tiles(const void* a, void* out, int n, int th, int tw,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (th == 32 && tw == 32) err = transpose_launch<32, 32>(a, out, n, s);
  else if (th == 64 && tw == 64) err = transpose_launch<64, 64>(a, out, n, s);
  else if (th == 32 && tw == 64) err = transpose_launch<32, 64>(a, out, n, s);
  else if (th == 64 && tw == 32) err = transpose_launch<64, 32>(a, out, n, s);
  else if (th == 32 && tw == 128) err = transpose_launch<32, 128>(a, out, n, s);
  else if (th == 128 && tw == 32) err = transpose_launch<128, 32>(a, out, n, s);
  return (int)err;
}

// Tiles 32 and 64.
extern "C" int strided_sym_two_read(const void* a, void* out, int n, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 32) return (int)sym_launch<32>(a, out, n, s);
  if (tile == 64) return (int)sym_launch<64>(a, out, n, s);
  return (int)cudaErrorInvalidValue;
}

// Tiles 32 and 64; ii/jj: the int32 upper-triangle worklist on the device.
extern "C" int strided_pair_tiles(const void* a, void* out, const void* ii, const void* jj,
                                  int npairs, int n, int tile, int do_transpose, int skip_diag,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 32) return (int)pair_launch<32>(a, out, ii, jj, npairs, n, do_transpose, skip_diag, s);
  if (tile == 64) return (int)pair_launch<64>(a, out, ii, jj, npairs, n, do_transpose, skip_diag, s);
  return (int)cudaErrorInvalidValue;
}
