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
// pair_tiles reads 16 bytes a thread: each thread loads its float4s of both
// tiles straight into registers, all before its first store (the diagonal's
// tile once). The copy stores them back as float4s, no thread staging
// anything; the symmetrize writes them into the padded tiles and stores S
// and S^T 4 bytes a thread, each warp a whole 128-byte line. One block a
// pair, as the TPU probe's grid. On an H100 it times within run-to-run
// spread of 4-byte loads through padded tiles, and the other designs
// measured were slower (PERF.md): a persistent grid walking the worklist
// through a cp.async ring with 4 x 4 register transposes, 1-D bulk copies,
// and float4 copies on a persistent grid.
//
// Arithmetic: __fadd_rn / __fmul_rn (no contraction), so every output equals
// the plain PyTorch version, (a + a.T) * 0.5, a.T or a, bit for bit. n must be
// a multiple of the tile, as in the TPU probes; pair_tiles takes a and out
// 16-byte aligned.
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

// pair_tiles: a pair's 2 T^2 floats as float4s, PER a thread; float4 k of
// a thread is row r < T of A[i,j] or row r - T of A[j,i], columns c .. c + 3
// of the row. On the diagonal the second tile is the first.
template <int T>
struct PairSlots {
  static constexpr int PER = 2 * T * T / 4 / (TX * TY), Q = T / 4;  // float4s a thread; a row
  static_assert(T * T / 4 % (TX * TY) == 0, "a thread's float4s split evenly over the tiles");
  int i, j, t;
  __device__ __forceinline__ void at(int k, int& r, int& c) const {
    const int idx = t + TX * TY * k;
    r = idx / Q;
    c = idx % Q * 4;
  }
  // the float4 of A (mirror: of the second tile) that slot k holds
  __device__ __forceinline__ int64_t offset(int k, int n) const {
    int r, c;
    at(k, r, c);
    return r < T ? (int64_t)(i * T + r) * n + j * T + c : (int64_t)(j * T + r - T) * n + i * T + c;
  }
};

template <int T, bool DO_T, bool SKIP_DIAG>
__global__ void __launch_bounds__(TX * TY)
pair_tiles_kernel(const float* __restrict__ a, float* __restrict__ out,
                  const int* __restrict__ ii, const int* __restrict__ jj, int n) {
  using P = PairSlots<T>;
  const P pair{__ldg(ii + blockIdx.x), __ldg(jj + blockIdx.x),
               (int)(threadIdx.y * TX + threadIdx.x)};
  const bool diag = pair.i == pair.j;
  float4 v[P::PER];
#pragma unroll
  for (int k = 0; k < P::PER; ++k)  // slots k >= PER / 2 hold the second tile
    if (k < P::PER / 2 || !diag) v[k] = __ldg((const float4*)(a + pair.offset(k, n)));
  if constexpr (!DO_T) {
    // out = A: each float4 back where it came from; on the diagonal the
    // second write (unless skipped) takes the first tile's float4
#pragma unroll
    for (int k = 0; k < P::PER; ++k) {
      if (k < P::PER / 2 || !diag) *(float4*)(out + pair.offset(k, n)) = v[k];
      else if (!SKIP_DIAG) *(float4*)(out + pair.offset(k, n)) = v[k - P::PER / 2];
    }
  } else {
    __shared__ float s0[T][T + 1], s1[T][T + 1];
#pragma unroll
    for (int k = 0; k < P::PER; ++k) {
      if (k >= P::PER / 2 && diag) continue;
      int r, c;
      pair.at(k, r, c);
      float* d = r < T ? &s0[r][c] : &s1[r - T][c];
      d[0] = v[k].x;
      d[1] = v[k].y;
      d[2] = v[k].z;
      d[3] = v[k].w;
    }
    __syncthreads();
    float(*m)[T + 1] = diag ? s0 : s1;  // the mirror tile A[j,i]
    const int i = pair.i, j = pair.j;
    const bool second = !(SKIP_DIAG && diag);
    // out[i,j] = S, S[r][c] = (s0[r][c] + m[c][r]) / 2; out[j,i] = S^T
    for_tile<T, T>([&](int r, int c) {
      out[(int64_t)(i * T + r) * n + j * T + c] = sym(s0[r][c], m[c][r]);
      if (second) out[(int64_t)(j * T + r) * n + i * T + c] = sym(s0[c][r], m[r][c]);
    });
  }
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
  if (!fits(n, T) || npairs != nb * (nb + 1) / 2 || (((uintptr_t)a | (uintptr_t)out) & 15))
    return cudaErrorInvalidValue;
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

// Tiles 32 and 64; ii/jj: the int32 upper-triangle worklist on the device;
// a and out 16-byte aligned.
extern "C" int strided_pair_tiles(const void* a, void* out, const void* ii, const void* jj,
                                  int npairs, int n, int tile, int do_transpose, int skip_diag,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 32) return (int)pair_launch<32>(a, out, ii, jj, npairs, n, do_transpose, skip_diag, s);
  if (tile == 64) return (int)pair_launch<64>(a, out, ii, jj, npairs, n, do_transpose, skip_diag, s);
  return (int)cudaErrorInvalidValue;
}
