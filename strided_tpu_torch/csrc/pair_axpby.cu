// K2: the tile-pair kernel, B = ep(alpha * A + beta * C^T) for square n x n.
//
// Replaces the Pallas kernel strided_tpu/core/kernels_special.py::
// _make_pair_kernel (driven by _pair_call_impl): the reference's flagship
// workload B = (A + A^T) / 2 and its family (A - A^T, 3A + 2A^T, A + C^T).
//
// What bounds it on an H100: bytes. Each element is read once from A (and
// once from C when C is another buffer) and written once: 8 bytes per f32
// element when C is A, 12 otherwise, against 3.35 TB/s; the arithmetic (a
// few flops per element) is negligible. A naive kernel reads one operand
// through a transposed (column) access, which touches a new 32-byte sector
// per element.
//
// Design: one 256-thread block per tile pair (i <= j) of the upper triangle.
// It loads the mirror tiles A[i,j] and A[j,i] (and C's for a distinct C)
// with coalesced row reads into shared memory, each padded by one column so
// the transposed reads hit 32 different banks, then writes the two output
// tiles B[i,j] and B[j,i] with coalesced row writes. On the diagonal it
// writes one tile. Edges are masked, so any n >= 1 works (the TPU kernel's
// 128-aligned core plus XLA strips is not needed). Lower-triangle blocks of
// the square grid exit at once.
//
// Arithmetic: exactly kernels_special._pair_term / _epilogue, so the result
// equals the plain PyTorch version bit for bit: a coefficient of 1 skips its
// multiply and -1 negates; only alpha == 0 drops a term; the term order of
// the source expression is kept; the epilogue is one multiply or one IEEE
// division. No contraction (__fmul_rn / __fadd_rn / __fdiv_rn); a bf16 value
// is rounded after every operation, as eager PyTorch does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // blockDim.y; each thread covers TILE / ROWS rows

struct PairArgs {
  int alpha_mode, beta_mode;  // 0: drop the term (alpha only), 1: x, -1: -x, 2: x * c
  float alpha, beta;
  int scale_mode;  // 0: none, 1: * scale, 2: / scale
  float scale;
  int plain_first;
};

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float coeff(float t, int mode, float c, bool bf) {
  if (mode == 1) return t;
  if (mode == -1) return -t;
  return rnd(__fmul_rn(t, c), bf);
}

__device__ __forceinline__ float pair_value(float a, float ct, const PairArgs& p, bool bf) {
  float s;
  if (p.alpha_mode == 0) {
    s = coeff(ct, p.beta_mode, p.beta, bf);
  } else {
    float ta = coeff(a, p.alpha_mode, p.alpha, bf);
    float tb = coeff(ct, p.beta_mode, p.beta, bf);
    s = rnd(p.plain_first ? __fadd_rn(ta, tb) : __fadd_rn(tb, ta), bf);
  }
  if (p.scale_mode == 1) s = rnd(__fmul_rn(s, p.scale), bf);
  if (p.scale_mode == 2) s = rnd(__fdiv_rn(s, p.scale), bf);
  return s;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Load tile (ti, tj) of X into s (row-major, padded), masked at the edge.
template <typename T>
__device__ __forceinline__ void load_tile(float (*s)[TILE + 1], const T* __restrict__ X,
                                          int n, int ti, int tj) {
  const int col = tj * TILE + threadIdx.x;
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int row = ti * TILE + r;
    if (row < n && col < n) s[r][threadIdx.x] = to_f<T>(X[(int64_t)row * n + col]);
  }
}

// Write output tile (ti, tj): element (r, x) = value(a[r][x], c[x][r]).
template <typename T, bool BF>
__device__ __forceinline__ void write_tile(T* __restrict__ B, int n, int ti, int tj,
                                           float (*a)[TILE + 1], float (*c)[TILE + 1],
                                           const PairArgs& p) {
  const int col = tj * TILE + threadIdx.x;
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int row = ti * TILE + r;
    if (row < n && col < n)
      B[(int64_t)row * n + col] = from_f<T>(pair_value(a[r][threadIdx.x], c[threadIdx.x][r], p, BF));
  }
}

template <typename T, bool SAME, bool BF>
__global__ void __launch_bounds__(TILE * ROWS)
pair_axpby_kernel(const T* __restrict__ A, const T* __restrict__ C, T* __restrict__ B, int n,
                  PairArgs p) {
  const int i = blockIdx.y, j = blockIdx.x;
  if (i > j) return;  // lower triangle: the pair (j, i) covers it
  __shared__ float sa_ij[TILE][TILE + 1], sa_ji[TILE][TILE + 1];
  __shared__ float sc_ij[SAME ? 1 : TILE][TILE + 1], sc_ji[SAME ? 1 : TILE][TILE + 1];
  load_tile<T>(sa_ij, A, n, i, j);
  load_tile<T>(sa_ji, A, n, j, i);
  if (!SAME) {
    load_tile<T>(sc_ij, C, n, i, j);
    load_tile<T>(sc_ji, C, n, j, i);
  }
  __syncthreads();
  // B[i,j] = ep(alpha A[i,j] + beta C[j,i]^T); B[j,i] = ep(alpha A[j,i] + beta C[i,j]^T)
  write_tile<T, BF>(B, n, i, j, sa_ij, SAME ? sa_ji : sc_ji, p);
  if (i != j) write_tile<T, BF>(B, n, j, i, sa_ji, SAME ? sa_ij : sc_ij, p);
}

template <typename T, bool BF>
cudaError_t launch(const void* a, const void* c, void* b, int n, const PairArgs& p,
                   cudaStream_t stream) {
  const int nb = (n + TILE - 1) / TILE;
  dim3 grid(nb, nb), block(TILE, ROWS);
  if (a == c)
    pair_axpby_kernel<T, true, BF><<<grid, block, 0, stream>>>(
        (const T*)a, (const T*)a, (T*)b, n, p);
  else
    pair_axpby_kernel<T, false, BF><<<grid, block, 0, stream>>>(
        (const T*)a, (const T*)c, (T*)b, n, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16. c == a selects the same-buffer (two-pass) kernel.
extern "C" int strided_pair_axpby(const void* a, const void* c, void* b, int n, int dtype,
                                  int alpha_mode, float alpha, int beta_mode, float beta,
                                  int scale_mode, float scale, int plain_first,
                                  void* stream) {
  if (n < 1 || n > 65535 * TILE) return (int)cudaErrorInvalidValue;
  PairArgs p{alpha_mode, beta_mode, alpha, beta, scale_mode, scale, plain_first};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dtype == 0 ? launch<float, false>(a, c, b, n, p, s)
                               : launch<__nv_bfloat16, true>(a, c, b, n, p, s);
  return (int)err;
}
