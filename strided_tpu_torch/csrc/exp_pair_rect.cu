// P2: the rectangular supertile-pair probe kernel, for square n x n f32.
//
// Replaces the Pallas kernel benchmarks/exp_pair_rect.py::_make_rect_kernel
// (driven by rect_pairs): does the pair schedule of K2 gain from tiles with
// twice-longer rows? A supertile (i, k) with 2k > i covers the column pair
// {2k, 2k+1} of tile row i: it loads A[iT:(i+1)T, 2kT:(2k+2)T] (T x 2T) and
// its mirror A[2kT:(2k+2)T, iT:(i+1)T] (2T x T), and writes
// S1 = (in1 + in2^T) * 0.5 and S1^T back to the same two places. The band no
// supertile covers (the diagonal band, and the last tile column when n / T
// is odd) is never written, as in the TPU probe.
//
// What bounds it on an H100: bytes (each covered element read once and
// written once) against 3.35 TB/s. One block per supertile from a worklist;
// both rectangles sit in shared memory padded by one column, so the row
// reads, the row writes of S1 and of S1^T are coalesced and the transposed
// reads hit 32 different banks; loops of constant trip count
// (probe_tiles.cuh) let each thread issue all its loads at once. T = 64 needs
// 66 KB of dynamic shared memory.
//
// Arithmetic: __fadd_rn / __fmul_rn, equal to (a + a.T) * 0.5 bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_tiles.cuh"

namespace {

using probe::for_tile;
using probe::sym;
using probe::TX;
using probe::TY;

template <int T>
constexpr int smem_bytes() { return (T * (2 * T + 1) + 2 * T * (T + 1)) * (int)sizeof(float); }

template <int T>
__global__ void __launch_bounds__(TX * TY)
rect_pairs_kernel(const float* __restrict__ a, float* __restrict__ out,
                  const int* __restrict__ ii, const int* __restrict__ kk, int n) {
  extern __shared__ float smem[];
  float(*s1)[2 * T + 1] = reinterpret_cast<float(*)[2 * T + 1]>(smem);           // T x 2T
  float(*s2)[T + 1] = reinterpret_cast<float(*)[T + 1]>(smem + T * (2 * T + 1));  // 2T x T
  const int ri = ii[blockIdx.x] * T, cj = kk[blockIdx.x] * 2 * T;
  for_tile<T, 2 * T>([&](int r, int c) { s1[r][c] = a[(int64_t)(ri + r) * n + cj + c]; });
  for_tile<2 * T, T>([&](int r, int c) { s2[r][c] = a[(int64_t)(cj + r) * n + ri + c]; });
  __syncthreads();
  // S1[r][c] = (s1[r][c] + s2[c][r]) * 0.5 at out[ri + r][cj + c] ...
  for_tile<T, 2 * T>([&](int r, int c) {
    out[(int64_t)(ri + r) * n + cj + c] = sym(s1[r][c], s2[c][r]);
  });
  // ... and S1^T at out[cj + c][ri + r]
  for_tile<2 * T, T>([&](int c, int r) {
    out[(int64_t)(cj + c) * n + ri + r] = sym(s1[r][c], s2[c][r]);
  });
}

template <int T>
cudaError_t launch(const void* a, void* out, const void* ii, const void* kk, int nwork, int n,
                   cudaStream_t s) {
  if (n <= 0 || n % (2 * T) != 0 || nwork < 1) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      rect_pairs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (attr != cudaSuccess) return attr;
  rect_pairs_kernel<T><<<nwork, dim3(TX, TY), smem_bytes<T>(), s>>>(
      (const float*)a, (float*)out, (const int*)ii, (const int*)kk, n);
  return cudaGetLastError();
}

}  // namespace

// T = 32 or 64; n a multiple of 2T; ii/kk: the int32 supertile worklist on
// the device, nwork entries.
extern "C" int strided_rect_pairs(const void* a, void* out, const void* ii, const void* kk,
                                  int nwork, int n, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 32) return (int)launch<32>(a, out, ii, kk, nwork, n, s);
  if (tile == 64) return (int)launch<64>(a, out, ii, kk, nwork, n, s);
  return (int)cudaErrorInvalidValue;
}
