// Fused over-relaxed ADMM for the box-constrained condensed QP (sm_90a).
//
// Replaces the Pallas kernel strided_tpu/mpc/qp.py::_fused_admm. For a batch
// of B scenarios with D = N*m decision variables, all `iters` iterations of
//
//   u     = (rho (z - y) - g) S          S = (H + rho I)^-1, D x D, row-major
//   u_rel = alpha u + (1 - alpha) z
//   z     = clip(u_rel + y, lo, hi)
//   y     = y + u_rel - z
//
// run inside one launch: each block owns BT batch rows, reads g and z0 once,
// keeps z, y and g in registers and the rhs tile in shared memory for every
// iteration, and writes only the final z.
//
// The products are plain IEEE FP32 FMAs on the CUDA cores: a TF32 product
// misses the solver's accuracy gate (first input within 1e-4 of a converged
// f64 oracle). S is used as given, never assumed symmetric. The block holds
// as many rows of S in shared memory as fit beside the rhs tile (a "panel").
// When all D rows fit (D <= ~220; the headline D = 200 takes 211 KB) S is
// loaded once per block and every iteration runs from shared memory;
// otherwise the panels are reloaded from L2 (all blocks read the same S)
// in every iteration.
//
// Thread layout: 8 warps; warp w owns rows [w*ROWS, w*ROWS+ROWS) of the
// block's tile, lane t owns columns {j*32 + t : j < NCT}. Within a warp
// every lane reads the same rhs values (a shared-memory broadcast) and
// consecutive S columns (no bank conflicts). The last column tile and the
// last row tile are masked, so any D <= 512 and any B >= 1 work.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int ROWS>
__device__ __forceinline__ void store_rows(float* dst, const float (&v)[ROWS]) {
  if constexpr (ROWS == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(ROWS == 2, "ROWS must be 2 or 4");
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

template <int ROWS>
__device__ __forceinline__ void load_rows(const float* src, float (&v)[ROWS]) {
  if constexpr (ROWS == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x; v[1] = t.y;
  }
}

// ROWS batch rows per warp, NCT column tiles of 32 per lane; KS rows of S
// per shared-memory panel.
template <int ROWS, int NCT>
__global__ void __launch_bounds__(kThreads, 1)
fused_admm_kernel(const float* __restrict__ g, const float* __restrict__ z0,
                  const float* __restrict__ S, const float* __restrict__ lo,
                  const float* __restrict__ hi, float* __restrict__ out,
                  int B, int D, int iters, float rho, float alpha, int KS) {
  constexpr int BT = kWarps * ROWS;  // batch rows per block
  // rhsT row stride: the pad of ROWS floats makes the vector stores of one
  // warp (consecutive k) hit distinct banks
  constexpr int LD = BT + ROWS;
  constexpr int DP = NCT * 32;  // D rounded up to whole column tiles
  extern __shared__ __align__(16) float smem[];
  float* rhsT = smem;            // [DP][LD], rhsT[k * LD + r] = rhs[r][k]
  float* spanel = smem + DP * LD;  // [KS][DP], rows [k0, k0 + KS) of S

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BT + ty * ROWS;

  float z[ROWS][NCT], y[ROWS][NCT], gr[ROWS][NCT], lo_r[NCT], hi_r[NCT];
#pragma unroll
  for (int j = 0; j < NCT; ++j) {
    const int c = j * 32 + tx;
    const bool cv = c < D;
    lo_r[j] = cv ? lo[c] : 0.f;
    hi_r[j] = cv ? hi[c] : 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = row0 + i;
      const bool v = cv && r < B;
      const size_t off = static_cast<size_t>(r) * D + c;
      gr[i][j] = v ? g[off] : 0.f;
      z[i][j] = v ? z0[off] : 0.f;
      y[i][j] = 0.f;
    }
  }

  const int npanels = (D + KS - 1) / KS;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NCT; ++j) {
      float v[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) v[i] = rho * (z[i][j] - y[i][j]) - gr[i][j];
      store_rows<ROWS>(rhsT + (j * 32 + tx) * LD + ty * ROWS, v);
    }

    float acc[ROWS][NCT];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < NCT; ++j) acc[i][j] = 0.f;

    for (int p = 0; p < npanels; ++p) {
      const int k0 = p * KS;
      const int kc = min(KS, D - k0);
      if (npanels > 1 || it == 0) {  // a single panel stays resident
        const float* src = S + static_cast<size_t>(k0) * D;
        for (int idx = threadIdx.x; idx < kc * D; idx += kThreads) {
          const int kk = idx / D;
          spanel[kk * DP + (idx - kk * D)] = __ldg(src + idx);
        }
      }
      __syncthreads();  // the panel and the rhs tile are complete

#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float a[ROWS];
        load_rows<ROWS>(rhsT + (k0 + kk) * LD + ty * ROWS, a);
#pragma unroll
        for (int j = 0; j < NCT; ++j) {
          const float s = spanel[kk * DP + j * 32 + tx];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(a[i], s, acc[i][j]);
        }
      }
      __syncthreads();  // reads done before the panel or rhs is rewritten
    }

#pragma unroll
    for (int j = 0; j < NCT; ++j) {
      if (j * 32 + tx >= D) continue;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float u_rel = alpha * acc[i][j] + (1.f - alpha) * z[i][j];
        const float zn = fminf(fmaxf(u_rel + y[i][j], lo_r[j]), hi_r[j]);
        y[i][j] = y[i][j] + u_rel - zn;
        z[i][j] = zn;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NCT; ++j) {
    const int c = j * 32 + tx;
    if (c >= D) continue;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = row0 + i;
      if (r < B) out[static_cast<size_t>(r) * D + c] = z[i][j];
    }
  }
}

template <int ROWS, int NCT>
cudaError_t launch(const float* g, const float* z0, const float* S,
                   const float* lo, const float* hi, float* out, int B, int D,
                   int iters, float rho, float alpha, cudaStream_t stream) {
  constexpr int BT = kWarps * ROWS;
  constexpr int LD = BT + ROWS;
  constexpr int DP = NCT * 32;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t rhs_bytes = sizeof(float) * DP * LD;
  const size_t row_bytes = sizeof(float) * DP;
  if (static_cast<size_t>(max_smem) < rhs_bytes + row_bytes) return cudaErrorInvalidValue;
  const int KS = static_cast<int>(
      std::min<size_t>(D, (static_cast<size_t>(max_smem) - rhs_bytes) / row_bytes));
  const size_t smem = rhs_bytes + KS * row_bytes;
  // above 48 KB of dynamic shared memory the launch is refused unless the
  // limit is raised first
  err = cudaFuncSetAttribute(fused_admm_kernel<ROWS, NCT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT);
  fused_admm_kernel<ROWS, NCT><<<grid, kThreads, smem, stream>>>(
      g, z0, S, lo, hi, out, B, D, iters, rho, alpha, KS);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers to contiguous f32 arrays: g, z0 and out
// (B, D); S (D, D); lo and hi (D,). Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int strided_fused_admm_f32(const float* g, const float* z0,
                                      const float* S, const float* lo,
                                      const float* hi, float* out, int B,
                                      int D, int iters, float rho, float alpha,
                                      void* stream) {
  if (B < 1 || D < 1 || D > 512 || iters < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STRIDED_ADMM_CASE(ROWS, NCT) \
  case NCT:                          \
    return launch<ROWS, NCT>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, s);
  switch ((D + 31) / 32) {
    STRIDED_ADMM_CASE(4, 1)
    STRIDED_ADMM_CASE(4, 2)
    STRIDED_ADMM_CASE(4, 3)
    STRIDED_ADMM_CASE(4, 4)
    STRIDED_ADMM_CASE(4, 5)
    STRIDED_ADMM_CASE(4, 6)
    STRIDED_ADMM_CASE(4, 7)
    STRIDED_ADMM_CASE(4, 8)
    STRIDED_ADMM_CASE(2, 9)
    STRIDED_ADMM_CASE(2, 10)
    STRIDED_ADMM_CASE(2, 11)
    STRIDED_ADMM_CASE(2, 12)
    STRIDED_ADMM_CASE(2, 13)
    STRIDED_ADMM_CASE(2, 14)
    STRIDED_ADMM_CASE(2, 15)
    STRIDED_ADMM_CASE(2, 16)
  }
#undef STRIDED_ADMM_CASE
  return cudaErrorInvalidValue;
}
