// P4-P6: the rank-4 reversal probe kernels, y[j0, j1, j2, j3] = x[j3, j2, j1, j0]
// for x of 64^4 f32 (j0 the fastest index of x, j3 the fastest of y).
//
// Replaces the Pallas kernels of benchmarks/exp_perm2.py (_call_mid: v_loop2d,
// v_chain, v_chain3, v_loop2d_nocompute, v_mxu), benchmarks/exp_perm4.py
// (v_grouped_j2, v_grouped_j1j2, v_plain4d, v_mxu, v_dma4d) and
// benchmarks/exp_perm_probe.py (_call3: v_direct, v_3stage, v_2stage_batch,
// v_loop_rank3; _call_m: v_direct_m, v_2stage_m, v_3stage_m): the TPU
// round's search for a fast in-kernel reversal, the reference's flagship
// permute. Every one computes the same reversal over one of two block
// geometries; only the on-chip route differs.
//
//   J2J1  a TPU block is a run of j2 times a run of j1, j3 and j0 whole: each
//         (j2, j1) gives a 64 x 64 (j3, j0) plane of x, rows of 256 bytes,
//         that lands transposed at y[:, j1, j2, :], rows of 256 bytes too;
//   J3J2  a TPU block is a run of b3 of j3 times a run of j2, j1 and j0
//         whole: each (j2, j1) gives a b3 x 64 (j3, j0) plane, and an output
//         row holds only b3 contiguous floats (kept as the TPU probe had it).
//
// Three kernels:
//   rev4_tiles  through shared memory padded by one column. PLANE stages one
//               (j3, j0) plane a pass (v_loop2d, v_loop_rank3); BLOCK stages
//               a 66.5 KB chunk of the TPU block (256 rows of j0) a pass and
//               writes it through the reversed index (direct, chain, chain3,
//               2stage, 3stage, plain4d, grouped, the _m forms). With COPY
//               the plane is copied untransposed to y[:, j1, j2, :], i.e.
//               x.permute(0, 2, 1, 3) (v_loop2d_nocompute).
//   rev4_mma    the reversal as an identity product on the tensor cores
//               (v_mxu): Y = I * X^T with mma.sync m16n8k16 bf16 inputs and
//               f32 accumulation, X read from shared memory as the B operand.
//               HIGHEST splits each f32 into three bf16 parts (hi, mid, lo,
//               each residual exact) and accumulates three products, which
//               gives x back bit for bit, as the TPU's HIGHEST does; DEFAULT
//               takes one product of bf16(x), as the TPU's DEFAULT does.
//   rev4_async  v_dma4d's manual double-buffered DMA: a two-stage ring of
//               (j3, j0) planes in shared memory filled by 16-byte
//               cp.async.cg; a plane is transposed while the next one loads.
//
// What bounds them on an H100: bytes, 2 * 64^4 * 4 = 134 MB (each element
// read once and written once) against 3.35 TB/s; the identity products do
// 2 * 64 flops an element a pass on the tensor cores, far below their
// bound. The TPU grids have 8-64 blocks, fewer than the card's 132 SMs:
// rev4_tiles and rev4_mma split every TPU block over several CTAs (grid.x)
// until the grid holds about 1056 CTAs; rev4_async's grid is c2-runs of j2
// times ranges of j1, 256 CTAs. Loops have constant trip counts, so a
// thread issues up to 16 loads of a pass at once (probe_tiles.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                 // the extent of each of the four axes
constexpr int D3 = D * D * D;         // stride of j3 in x and of j0 in y
constexpr int TARGET_CTAS = 8 * 132;  // rev4_tiles, rev4_mma: CTAs a grid aims at
enum { J2J1 = 0, J3J2 = 1 };
enum { PLANE = 0, BLOCK = 1 };

// Plane q of TPU block blk: its j3 origin and its (j2, j1). ra, rb: the
// block's runs (J2J1: of j2 and j1; J3J2: of j3 and j2).
template <int GEOM>
__device__ __forceinline__ void plane_of(int ra, int rb, int blk, int q, int& j3o, int& j2,
                                         int& j1) {
  const int ga = blk / (D / rb), gb = blk % (D / rb);
  if (GEOM == J2J1) {
    j3o = 0;
    j2 = ga * ra + q / rb;
    j1 = gb * rb + q % rb;
  } else {
    j3o = ga * ra;
    j2 = gb * rb + q / D;
    j1 = q % D;
  }
}

// --------------------------------------------------------------------------
// rev4_tiles: NPL planes of E3 x 64 a pass, through s[NPL][E3][D + 1].
template <int GEOM, int E3, int NPL, bool COPY>
__global__ void __launch_bounds__(256)
rev4_tiles_kernel(const float* __restrict__ x, float* __restrict__ y, int ra, int rb,
                  int passes) {
  constexpr int P = D + 1, ELEMS = NPL * E3 * D, PER_THREAD = ELEMS / 256;
  static_assert(ELEMS % 256 == 0 && (E3 * D) % 256 == 0, "a pass is whole rows of 256 threads");
  extern __shared__ float s[];
  __shared__ int in_base[NPL], out_base[NPL];
  const int t = threadIdx.x;
  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = (blockIdx.x * passes + pass) * NPL;
    if (t < NPL) {
      int j3o, j2, j1;
      plane_of<GEOM>(ra, rb, blockIdx.y, q0 + t, j3o, j2, j1);
      in_base[t] = ((j3o * D + j2) * D + j1) * D;
      out_base[t] = COPY ? ((j3o * D + j1) * D + j2) * D : (j1 * D + j2) * D + j3o;
    }
    __syncthreads();
    // read: j0 fastest, rows of 256 bytes; 16 loads in flight a thread (a
    // full unroll of BLOCK's 64 took 255 registers: one CTA an SM)
#pragma unroll 16
    for (int k = 0; k < PER_THREAD; ++k) {
      const int idx = t + k * 256;
      const int j0 = idx % D, j3 = (idx / D) % E3, pl = (k * 256) / (E3 * D);
      s[(pl * E3 + j3) * P + j0] = __ldg(x + in_base[pl] + j3 * D3 + j0);
    }
    __syncthreads();
#pragma unroll 16
    for (int k = 0; k < PER_THREAD; ++k) {
      const int idx = t + k * 256, pl = (k * 256) / (E3 * D);
      if (COPY) {  // y[j3, j1, j2, j0] = x[j3, j2, j1, j0]: j0 fastest
        const int j0 = idx % D, j3 = (idx / D) % E3;
        y[out_base[pl] + j3 * D3 + j0] = s[(pl * E3 + j3) * P + j0];
      } else {  // y[j0, j1, j2, j3]: j3 fastest, the column read of s
        const int j3 = idx % E3, j0 = (idx / E3) % D;
        y[out_base[pl] + j0 * D3 + j3] = s[(pl * E3 + j3) * P + j0];
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// rev4_mma: one 64 x 64 (j3, j0) plane a pass; warp w computes the rows
// j0 = 16w .. 16w + 15 of Y = X^T as D_tile = I_16 * B_tile, B[k][n] =
// X[n][k] (the plane's own rows: mma's "col" B operand), 8 tiles of n.
constexpr int MMA_PITCH = D + 8;  // 288 bytes: float4 rows, conflict-free float2 fragment reads

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + mid + lo exactly: each residual has at most 16, then 8,
// significant bits, and bf16 keeps f32's exponent range.
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
}

template <int GEOM, bool HIGHEST>
__global__ void __launch_bounds__(128)
rev4_mma_kernel(const float* __restrict__ x, float* __restrict__ y, int ra, int rb, int passes) {
  __shared__ __align__(16) float s[D][MMA_PITCH];
  const int t = threadIdx.x, lane = t % 32, w = t / 32, g = lane / 4, tq = lane % 4;
  // the 16 x 16 identity as mma's A fragment: rows g and g + 8, columns
  // 2tq, 2tq + 1 (a0, a1) and 2tq + 8, 2tq + 9 (a2, a3)
  const uint32_t one = 0x3F80u;  // bf16 1.0
  const uint32_t diag = (g == 2 * tq ? one : 0u) | (g == 2 * tq + 1 ? one << 16 : 0u);
  const uint32_t a[4] = {diag, 0u, 0u, diag};
  for (int pass = 0; pass < passes; ++pass) {
    int j3o, j2, j1;
    plane_of<GEOM>(ra, rb, blockIdx.y, blockIdx.x * passes + pass, j3o, j2, j1);
    const int in_base = ((j3o * D + j2) * D + j1) * D, out_base = (j1 * D + j2) * D + j3o;
#pragma unroll
    for (int k = 0; k < D * D / 4 / 128; ++k) {  // float4 loads, rows of 256 bytes
      const int idx = t + k * 128, j3 = idx / (D / 4), c = idx % (D / 4) * 4;
      *(float4*)&s[j3][c] = __ldg((const float4*)(x + in_base + j3 * D3 + c));
    }
    __syncthreads();
    const int kcol = 16 * w + 2 * tq;  // B rows k (= j0) of this warp's tiles
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int n = 8 * nt + g;  // B column (= j3)
      const float2 v0 = *(const float2*)&s[n][kcol];
      const float2 v1 = *(const float2*)&s[n][kcol + 8];
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (HIGHEST) {
        __nv_bfloat16 p00[3], p01[3], p10[3], p11[3];
        split3(v0.x, p00);
        split3(v0.y, p01);
        split3(v1.x, p10);
        split3(v1.y, p11);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_bf16(c, a, pack(p00[part], p01[part]), pack(p10[part], p11[part]));
      } else {
        mma_bf16(c, a, pack(__float2bfloat16_rn(v0.x), __float2bfloat16_rn(v0.y)),
                 pack(__float2bfloat16_rn(v1.x), __float2bfloat16_rn(v1.y)));
      }
      // D rows j0 = 16w + g (c0, c1) and + 8 (c2, c3), columns j3 = 8nt + 2tq, + 1
      const int j0 = 16 * w + g, j3 = 8 * nt + 2 * tq;
      *(float2*)(y + out_base + j0 * D3 + j3) = make_float2(c[0], c[1]);
      *(float2*)(y + out_base + (j0 + 8) * D3 + j3) = make_float2(c[2], c[3]);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// rev4_async: CTA (run, range) owns the planes j2 in run * c2 .. + c2, j1 in
// range * j1n .. + j1n, a ring of two (j3, j0) planes of pitch 68 (rows
// 16-byte aligned for cp.async; the float4 column reads of 8 lanes hit 32
// different banks).
constexpr int RING_PITCH = D + 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem));
}

__global__ void __launch_bounds__(256)
rev4_async_kernel(const float* __restrict__ x, float* __restrict__ y, int c2, int j1n) {
  __shared__ __align__(16) float s[2][D][RING_PITCH];
  const int t = threadIdx.x, planes = c2 * j1n;
  auto plane = [&](int q, int& j2, int& j1) {
    j2 = blockIdx.x * c2 + q / j1n;
    j1 = blockIdx.y * j1n + q % j1n;
  };
  auto load = [&](int stage, int q) {
    int j2, j1;
    plane(q, j2, j1);
    const float* src = x + (j2 * D + j1) * D;
#pragma unroll
    for (int k = 0; k < D * D / 4 / 256; ++k) {
      const int idx = t + k * 256, j3 = idx / (D / 4), c = idx % (D / 4) * 4;
      cp_async16(&s[stage][j3][c], src + j3 * D3 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load(0, 0);
  for (int q = 0; q < planes; ++q) {
    if (q + 1 < planes) {
      load((q + 1) % 2, q + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    int j2, j1;
    plane(q, j2, j1);
    float* dst = y + (j1 * D + j2) * D;
#pragma unroll
    for (int k = 0; k < D * D / 4 / 256; ++k) {  // lanes on consecutive j3: 128-byte rows
      const int idx = t + k * 256, j3 = idx % D, c = idx / D * 4;
      const float4 v = *(const float4*)&s[q % 2][j3][c];
      dst[(c + 0) * D3 + j3] = v.x;
      dst[(c + 1) * D3 + j3] = v.y;
      dst[(c + 2) * D3 + j3] = v.z;
      dst[(c + 3) * D3 + j3] = v.w;
    }
    __syncthreads();  // the stage is refilled by the next iteration's load
  }
}

// --------------------------------------------------------------------------
// Host side.

bool runs_ok(int d, int ra, int rb) {
  return d == D && ra >= 1 && rb >= 1 && D % ra == 0 && D % rb == 0;
}

// The largest divisor of units that keeps the grid near TARGET_CTAS.
int choose_split(int units, int nblk) {
  const int want = (TARGET_CTAS + nblk - 1) / nblk;
  int split = 1;
  for (int s = 1; s <= units && s <= want; ++s)
    if (units % s == 0) split = s;
  return split;
}

template <int GEOM, int E3, int NPL, bool COPY>
cudaError_t tiles_launch(const float* x, float* y, int ra, int rb, cudaStream_t s) {
  const int planes = GEOM == J2J1 ? ra * rb : rb * D;
  if (planes % NPL != 0) return cudaErrorInvalidValue;
  const int nblk = (D / ra) * (D / rb), units = planes / NPL;
  const int split = choose_split(units, nblk);
  const int smem = NPL * E3 * (D + 1) * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      rev4_tiles_kernel<GEOM, E3, NPL, COPY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  rev4_tiles_kernel<GEOM, E3, NPL, COPY><<<dim3(split, nblk), 256, smem, s>>>(x, y, ra, rb,
                                                                            units / split);
  return cudaGetLastError();
}

// J3J2: E3 = ra; NPL = 1 (PLANE) or 256 / E3 (BLOCK, 66.5 KB).
template <int E3>
cudaError_t tiles_j3j2(const float* x, float* y, int ra, int rb, int staging, cudaStream_t s) {
  if (staging == PLANE) return tiles_launch<J3J2, E3, 1, false>(x, y, ra, rb, s);
  return tiles_launch<J3J2, E3, 256 / E3, false>(x, y, ra, rb, s);
}

template <int GEOM, bool HIGHEST>
cudaError_t mma_launch(const float* x, float* y, int ra, int rb, cudaStream_t s) {
  const int units = GEOM == J2J1 ? ra * rb : rb * D;
  const int nblk = (D / ra) * (D / rb), split = choose_split(units, nblk);
  rev4_mma_kernel<GEOM, HIGHEST><<<dim3(split, nblk), 128, 0, s>>>(x, y, ra, rb, units / split);
  return cudaGetLastError();
}

}  // namespace

// x, y: 64^4 f32 (d = 64). geom J2J1 (0): ra, rb runs of j2 and j1; J3J2 (1):
// ra = b3 in {8, 16, 64}, rb a run of j2. staging PLANE (0) or BLOCK (1);
// copy = 1 (J2J1, PLANE only) writes x.permute(0, 2, 1, 3).
extern "C" int strided_rev4_tiles(const void* x, void* y, int d, int geom, int ra, int rb,
                                  int staging, int copy, void* stream) {
  if (!runs_ok(d, ra, rb) || (staging != PLANE && staging != BLOCK) || (geom != J2J1 && geom != J3J2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)x;
  float* b = (float*)y;
  if (copy) {
    if (geom != J2J1 || staging != PLANE) return (int)cudaErrorInvalidValue;
    return (int)tiles_launch<J2J1, D, 1, true>(a, b, ra, rb, s);
  }
  if (geom == J2J1)
    return (int)(staging == PLANE ? tiles_launch<J2J1, D, 1, false>(a, b, ra, rb, s)
                                  : tiles_launch<J2J1, D, 4, false>(a, b, ra, rb, s));
  if (ra == 8) return (int)tiles_j3j2<8>(a, b, ra, rb, staging, s);
  if (ra == 16) return (int)tiles_j3j2<16>(a, b, ra, rb, staging, s);
  if (ra == 64) return (int)tiles_j3j2<64>(a, b, ra, rb, staging, s);
  return (int)cudaErrorInvalidValue;
}

// geom as above; J3J2 needs ra = 64 (whole (j3, j0) planes). highest = 1:
// three bf16 parts (exact); 0: one product of bf16(x).
extern "C" int strided_rev4_mma(const void* x, void* y, int d, int geom, int ra, int rb,
                                int highest, void* stream) {
  if (!runs_ok(d, ra, rb) || (geom != J2J1 && geom != J3J2) || (geom == J3J2 && ra != D) ||
      ((uintptr_t)x & 15) || ((uintptr_t)y & 7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)x;
  float* b = (float*)y;
  if (geom == J2J1)
    return (int)(highest ? mma_launch<J2J1, true>(a, b, ra, rb, s)
                         : mma_launch<J2J1, false>(a, b, ra, rb, s));
  return (int)(highest ? mma_launch<J3J2, true>(a, b, ra, rb, s)
                       : mma_launch<J3J2, false>(a, b, ra, rb, s));
}

// c2: the run of j2 a CTA owns (divides 64); its j1 range is 16 / c2 planes
// long (at least 1), so a CTA transposes 16 planes and the grid holds 256.
extern "C" int strided_rev4_async(const void* x, void* y, int d, int c2, void* stream) {
  if (!runs_ok(d, c2, 1) || ((uintptr_t)x & 15)) return (int)cudaErrorInvalidValue;
  const int j1n = c2 >= 16 ? 1 : 16 / c2;
  rev4_async_kernel<<<dim3(D / c2, D / j1n), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, c2, j1n);
  return (int)cudaGetLastError();
}
