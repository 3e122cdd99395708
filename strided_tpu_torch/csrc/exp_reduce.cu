// P3: the streaming-reduction probe kernel, out[c] = sum over r of A[r, c]
// for a dense (n, m) f32 matrix, in slabs of R x C.
//
// Replaces the Pallas kernel benchmarks/exp_reduce.py::_make_stream_kernel
// (driven by stream_sum_axis0), the TPU prototype of K3: a manual
// double-buffered DMA of (R, C) slabs into a C-vector accumulator, over a
// grid of (m / C column blocks, parallel) x (n / R row slabs, sequential).
// With compute off it reads every slab and writes A[0]: the schedule's
// speed of light.
//
// What bounds it on an H100: bytes, n * m * 4 read once and m * 4 written,
// against 3.35 TB/s. The TPU grid does not carry over (at C = 2048 it is 4
// column blocks for 132 SMs), and no accumulator can be carried from one
// block to the next. Here pass 1 folds each R x C slab into a C-vector
// partial (slab_sum_kernel) and pass 2 folds the n / R partials of a column
// in slab order (merge_slabs_kernel): deterministic, no atomics, as K3.
//
// A slab is folded by C / 128 blocks of 32 x 8 threads, one per 128-column
// segment: a thread owns 4 adjacent columns (one 16-byte load a row) and
// every 8th row of the slab, R / 8 rows of constant trip count unrolled 8
// deep; the 8 row lanes are then merged in lane order through shared
// memory. The blocks are numbered column block, then row slab, then
// segment, so C sets which columns are read together, as the TPU grid's
// outer dimension did; it does not change the result.
//
// compute = false: the loads must stay, or nvcc removes them. Each thread
// folds the bits it read with xor, and stores the fold into the scratch
// buffer (never into out) only when it equals a value no input of the
// probes produces; the slab-0 blocks write row 0 to out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32, TY = 8;  // 256 threads: 32 lanes of 4 columns, 8 row lanes
constexpr int SEG = TX * 4;     // columns a block covers
constexpr uint32_t SINK = 0x7fc0dead;  // a NaN payload the xor fold never meets on real data

template <int R, bool COMPUTE>
__global__ void __launch_bounds__(TX * TY)
slab_sum_kernel(const float* __restrict__ a, float* __restrict__ out,
                float* __restrict__ partial, int m, int C, int nR) {
  static_assert(R % (TY * 8) == 0, "R must be a multiple of 64");
  const int segs = C / SEG;  // blocks a slab
  const int b = blockIdx.x;
  const int seg = b % segs, rs = (b / segs) % nR, cb = b / segs / nR;
  const int64_t col = (int64_t)cb * C + seg * SEG + threadIdx.x * 4;
  const float* p = a + ((int64_t)rs * R + threadIdx.y) * m + col;
  if (COMPUTE) {
    __shared__ float4 part[TY][TX];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < R; r += TY) {
      const float4 v = __ldg((const float4*)(p + (int64_t)r * m));
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    part[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y != 0) return;
#pragma unroll
    for (int l = 1; l < TY; ++l) {
      const float4 v = part[l][threadIdx.x];
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    *(float4*)(partial + (int64_t)rs * m + col) = acc;
  } else {
    if (rs == 0 && threadIdx.y == 0) *(float4*)(out + col) = __ldg((const float4*)p);  // A[0]
    uint32_t fold = 0;
#pragma unroll 8
    for (int r = 0; r < R; r += TY) {
      const uint4 v = __ldg((const uint4*)(p + (int64_t)r * m));
      fold ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    if (fold == SINK) partial[(int64_t)rs * m + col] = __uint_as_float(fold);
  }
}

// out[c] = partial[0][c] + partial[1][c] + ... in slab order.
__global__ void merge_slabs_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int m, int nR) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= m) return;
  float acc = partial[c];
  for (int s = 1; s < nR; ++s) acc = __fadd_rn(acc, partial[(int64_t)s * m + c]);
  out[c] = acc;
}

template <int R>
cudaError_t launch(const float* a, float* out, float* partial, int n, int m, int C, int compute,
                   cudaStream_t s) {
  if (n % R != 0 || C % SEG != 0 || m % C != 0) return cudaErrorInvalidValue;
  const int nR = n / R;
  const int64_t blocks = (int64_t)(m / C) * nR * (C / SEG);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (compute)
    slab_sum_kernel<R, true><<<(unsigned)blocks, dim3(TX, TY), 0, s>>>(a, out, partial, m, C, nR);
  else
    slab_sum_kernel<R, false><<<(unsigned)blocks, dim3(TX, TY), 0, s>>>(a, out, partial, m, C, nR);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !compute) return err;
  merge_slabs_kernel<<<(m + 255) / 256, 256, 0, s>>>(partial, out, m, nR);
  return cudaGetLastError();
}

}  // namespace

// a: (n, m) f32; out: (m,); partial: (n / R) * m floats.
// R in {128, 256, 512, 1024}; C a multiple of 128 that divides m; all three
// buffers 16-byte aligned.
extern "C" int strided_stream_sum_slabs(const void* a, void* out, void* partial, int n, int m,
                                        int R, int C, int compute, void* stream) {
  if (n < 1 || m < 1 || C < 1 || ((uintptr_t)a & 15) || ((uintptr_t)out & 15) ||
      ((uintptr_t)partial & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)a;
  float *y = (float*)out, *p = (float*)partial;
  if (R == 128) return (int)launch<128>(x, y, p, n, m, C, compute, s);
  if (R == 256) return (int)launch<256>(x, y, p, n, m, C, compute, s);
  if (R == 512) return (int)launch<512>(x, y, p, n, m, C, compute, s);
  if (R == 1024) return (int)launch<1024>(x, y, p, n, m, C, compute, s);
  return (int)cudaErrorInvalidValue;
}
