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
// Two kernels:
//   rev4_tiles  16-byte copies through a three-stage cp.async ring of (j3,
//               j0) rows in shared memory (ring_run): the next two stages'
//               copies are in flight while a stage is transposed and stored,
//               one barrier a pass. A thread reads a 4 x 4 sub-block of the stage
//               (4 float4 rows), transposes it in registers and stores 4
//               float4 rows of y. PLANE stages one (j3, j0) plane (E3 rows: 64,
//               or b3 of J3J2), BLOCK 128 rows of the TPU block (2 planes of
//               64 rows, or 128 / b3 of b3): the staging the TPU variants
//               chose, as a stage size. With COPY the plane is copied
//               untransposed to y[:, j1, j2, :], x.permute(0, 2, 1, 3)
//               (v_loop2d_nocompute): float4 loads straight to float4 stores.
//               rev4_async (v_dma4d's manual double-buffered DMA: a CTA owns
//               a c2-run of j2 times a run of j1) is this kernel's J2J1 PLANE
//               instance with one CTA a TPU block.
//   rev4_mma    the reversal as an identity product on the tensor cores
//               (v_mxu): Y = I * X^T with mma.sync m16n8k16 bf16 inputs and
//               f32 accumulation, X read from shared memory as the B operand.
//               HIGHEST splits each f32 into three bf16 parts (hi, mid, lo,
//               each residual exact) and accumulates three products, which
//               gives x back bit for bit, as the TPU's HIGHEST does; DEFAULT
//               takes one product of bf16(x), as the TPU's DEFAULT does.
//
// What bounds them on an H100: bytes, 2 * 64^4 * 4 = 134 MB (each element
// read once and written once) against 3.35 TB/s; the identity products do
// 2 * 64 flops an element a pass on the tensor cores, far below their
// bound. Reversal GB/s follows access width (PERF.md): both ways are 16
// bytes a thread here. The TPU grids have 8-64 blocks, fewer than the card's
// 132 SMs: every TPU block is split over several CTAs (grid.x) until the
// grid fills one wave of the card (rev4_tiles: as many CTAs as the
// occupancy calculator lets reside; rev4_mma: about TARGET_CTAS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_tiles.cuh"

namespace {

constexpr int D = 64;                 // the extent of each of the four axes
constexpr int D3 = D * D * D;         // stride of j3 in x and of j0 in y
constexpr int TARGET_CTAS = 8 * 132;  // rev4_mma: CTAs a grid aims at
enum { J2J1 = 0, J3J2 = 1 };
enum { PLANE = 0, BLOCK = 1 };

// Plane q of TPU block blk: its j3 origin and its (j2, j1). la, lb: log2 of
// the block's runs (J2J1: of j2 and j1; J3J2: of j3 and j2); every run
// divides 64, so every run is a power of two.
template <int GEOM>
__device__ __forceinline__ void plane_of(int la, int lb, int blk, int q, int& j3o, int& j2,
                                         int& j1) {
  const int ga = blk >> (6 - lb), gb = blk & ((D >> lb) - 1);  // blk / (D / rb), blk % (D / rb)
  if (GEOM == J2J1) {
    j3o = 0;
    j2 = (ga << la) + (q >> lb);
    j1 = (gb << lb) + (q & ((1 << lb) - 1));
  } else {
    j3o = ga << la;
    j2 = (gb << lb) + q / D;
    j1 = q % D;
  }
}

// The ring's rows are whole (j3, j0) rows of 64 floats (probe_tiles.cuh).
constexpr int RING_PITCH = probe::ring_pitch<D>;
constexpr int BLOCK_ROWS = 128;  // BLOCK's stage: 34.8 KB, so the ring leaves 2 CTAs an SM

// --------------------------------------------------------------------------
// rev4_tiles. The launch policy of an instance, read by the kernel and by
// the launcher alike: rows a stage, planes a stage, threads (one 4 x 4
// sub-block a thread at least), stages of the ring and dynamic shared
// memory (none for COPY, which does not stage).
template <int E3, int STAGING, bool COPY>
struct Tiles {
  static constexpr int ROWS = STAGING == PLANE ? E3 : BLOCK_ROWS;
  static constexpr int NPL = ROWS / E3;
  static constexpr int THREADS = 4 * ROWS < 256 ? 4 * ROWS : 256;
  // three stages (two fills in flight) beat two at one more CTA an SM (PERF.md)
  static constexpr int STAGES = 3;
  static constexpr int SMEM = COPY ? 0 : STAGES * ROWS * RING_PITCH * (int)sizeof(float);
  static_assert(E3 % 4 == 0 && ROWS % E3 == 0, "sub-blocks lie within a plane");
};

// The planes of this CTA: plane pl of pass p at offset in of x (its row j3
// = j3o) and out of y (its row j0 = 0; COPY: its row j3 = j3o), row j3o + j
// of the plane j * D3 further on in both.
template <int GEOM, int NPL, bool COPY>
struct Planes {
  int la, lb, passes;
  __device__ __forceinline__ void at(int p, int pl, int& in, int& out) const {
    int j3o, j2, j1;
    plane_of<GEOM>(la, lb, blockIdx.y, (blockIdx.x * passes + p) * NPL + pl, j3o, j2, j1);
    in = j3o * D3 + (j2 * D + j1) * D;
    out = COPY ? j3o * D3 + (j1 * D + j2) * D : (j1 * D + j2) * D + j3o;
  }
};

// ring_fill's source: stage row r of pass p is row r % E3 of plane r / E3.
template <int GEOM, int E3, int NPL>
struct RowsOfX {
  const float* x;
  Planes<GEOM, NPL, false> planes;
  __device__ __forceinline__ const float* operator()(int p, int r) const {
    int in, out;
    planes.at(p, r / E3, in, out);
    return x + in + r % E3 * D3;
  }
};

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sub-block u of a stage of ROWS rows: rows 4a .. 4a + 3, columns 4b .. 4b
// + 3. The 8 lanes of a float4 phase take b = 0..3 and both parities of a:
// 16 * (a % 2) + 4 * b covers the 32 banks once (pitch 68), so the reads are
// free of conflicts; the 32 lanes of a warp take 4 values of b and up to 8
// of a, so a store writes 4 rows of y, 128 contiguous bytes each where a
// plane's rows allow.
template <int ROWS>
__device__ __forceinline__ void sub_block(int u, int& a, int& b) {
  constexpr int LA = ROWS / 4 >= 8 ? 3 : ROWS / 4 == 4 ? 2 : 1;
  b = (u & 3) | (((u >> (2 + LA)) & 3) << 2);
  a = ((u >> 2) & ((1 << LA) - 1)) | ((u >> (4 + LA)) << LA);
}

// ring_run's use: each sub-block of the stage read as 4 float4 rows (j3),
// transposed in registers and stored as 4 float4 rows of y (j0).
template <int GEOM, int E3, int ROWS, int THREADS>
struct TransposeStage {
  float* y;
  Planes<GEOM, ROWS / E3, false> planes;
  __device__ __forceinline__ void operator()(const float* st, int p) const {
#pragma unroll
    for (int k = 0; k < 4 * ROWS / THREADS; ++k) {
      int a, b;
      sub_block<ROWS>(threadIdx.x + k * THREADS, a, b);
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = *(const float4*)(st + (4 * a + i) * RING_PITCH + 4 * b);
      int in, out;
      planes.at(p, 4 * a / E3, in, out);
      float* dst = y + out + 4 * b * D3 + 4 * a % E3;  // rows j0 = 4b.., columns j3 = 4a..
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *(float4*)(dst + i * D3) =
            make_float4(part(v[0], i), part(v[1], i), part(v[2], i), part(v[3], i));
    }
  }
};

template <int GEOM, int E3, int STAGING, bool COPY>
__global__ void __launch_bounds__(Tiles<E3, STAGING, COPY>::THREADS)
rev4_tiles_kernel(const float* __restrict__ x, float* __restrict__ y, int la, int lb,
                  int passes) {
  using T = Tiles<E3, STAGING, COPY>;
  constexpr int ROWS = T::ROWS, THREADS = T::THREADS;
  const Planes<GEOM, T::NPL, COPY> planes{la, lb, passes};
  if constexpr (COPY) {  // y[j3, j1, j2, j0] = x[j3, j2, j1, j0]: rows of 256 bytes
    constexpr int PER = ROWS * D / 4 / THREADS;
    for (int p = 0; p < passes; ++p) {
      float4 v[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = threadIdx.x + k * THREADS, r = idx / (D / 4), c = idx % (D / 4) * 4;
        int in, out;
        planes.at(p, r / E3, in, out);
        v[k] = __ldg((const float4*)(x + in + r % E3 * D3 + c));
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = threadIdx.x + k * THREADS, r = idx / (D / 4), c = idx % (D / 4) * 4;
        int in, out;
        planes.at(p, r / E3, in, out);
        *(float4*)(y + out + r % E3 * D3 + c) = v[k];
      }
    }
  } else {
    extern __shared__ __align__(16) float ring[];
    probe::ring_run<T::STAGES, ROWS, D, THREADS>(ring, passes,
                                                 RowsOfX<GEOM, E3, T::NPL>{x, planes},
                                                 TransposeStage<GEOM, E3, ROWS, THREADS>{y, planes});
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
rev4_mma_kernel(const float* __restrict__ x, float* __restrict__ y, int la, int lb, int passes) {
  __shared__ __align__(16) float s[D][MMA_PITCH];
  const int t = threadIdx.x, lane = t % 32, w = t / 32, g = lane / 4, tq = lane % 4;
  // the 16 x 16 identity as mma's A fragment: rows g and g + 8, columns
  // 2tq, 2tq + 1 (a0, a1) and 2tq + 8, 2tq + 9 (a2, a3)
  const uint32_t one = 0x3F80u;  // bf16 1.0
  const uint32_t diag = (g == 2 * tq ? one : 0u) | (g == 2 * tq + 1 ? one << 16 : 0u);
  const uint32_t a[4] = {diag, 0u, 0u, diag};
  for (int pass = 0; pass < passes; ++pass) {
    int j3o, j2, j1;
    plane_of<GEOM>(la, lb, blockIdx.y, blockIdx.x * passes + pass, j3o, j2, j1);
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
// Host side.

bool runs_ok(int d, int ra, int rb) {
  return d == D && ra >= 1 && rb >= 1 && D % ra == 0 && D % rb == 0;
}

int log2_of(int v) { return 31 - __builtin_clz((unsigned)v); }

// The largest divisor of units that is at most want (at least 1).
int choose_split(int units, int want) {
  int split = 1;
  for (int s = 1; s <= units && s <= want; ++s)
    if (units % s == 0) split = s;
  return split;
}

// Once per instance: its dynamic shared memory allowed, and the CTAs of it
// that reside on the card at once (occupancy calculator times SMs).
template <class K>
cudaError_t instance_setup(K kernel, int threads, int smem, int& resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  resident = per_sm * sms;
  return e;
}

// The launch policy: T's stage, threads and shared memory; a grid of TPU
// blocks (grid.y) each split over grid.x CTAs of equal passes, one wave of
// the card's resident CTAs (one_cta_a_block: one CTA a TPU block, as
// v_dma4d's program per block).
template <int GEOM, int E3, int STAGING, bool COPY>
cudaError_t tiles_launch(const float* x, float* y, int ra, int rb, bool one_cta_a_block,
                         cudaStream_t s) {
  using T = Tiles<E3, STAGING, COPY>;
  const int planes = GEOM == J2J1 ? ra * rb : rb * D;
  if (planes % T::NPL != 0) return cudaErrorInvalidValue;
  static int resident = 0;
  static const cudaError_t ready = instance_setup(rev4_tiles_kernel<GEOM, E3, STAGING, COPY>,
                                                  T::THREADS, T::SMEM, resident);
  if (ready != cudaSuccess) return ready;
  const int nblk = (D / ra) * (D / rb), units = planes / T::NPL;
  const int split = one_cta_a_block ? 1 : choose_split(units, resident / nblk);
  rev4_tiles_kernel<GEOM, E3, STAGING, COPY><<<dim3(split, nblk), T::THREADS, T::SMEM, s>>>(
      x, y, log2_of(ra), log2_of(rb), units / split);
  return cudaGetLastError();
}

template <int GEOM, bool HIGHEST>
cudaError_t mma_launch(const float* x, float* y, int ra, int rb, cudaStream_t s) {
  const int units = GEOM == J2J1 ? ra * rb : rb * D;
  const int nblk = (D / ra) * (D / rb);
  const int split = choose_split(units, (TARGET_CTAS + nblk - 1) / nblk);
  rev4_mma_kernel<GEOM, HIGHEST><<<dim3(split, nblk), 128, 0, s>>>(x, y, log2_of(ra), log2_of(rb),
                                                                 units / split);
  return cudaGetLastError();
}

bool aligned16(const void* x, const void* y) { return (((uintptr_t)x | (uintptr_t)y) & 15) == 0; }

}  // namespace

// x, y: 64^4 f32 (d = 64), 16-byte aligned. geom J2J1 (0): ra, rb runs of j2
// and j1; J3J2 (1): ra = b3 in {8, 16, 64}, rb a run of j2. staging PLANE
// (0) or BLOCK (1); copy = 1 (J2J1, PLANE only) writes x.permute(0, 2, 1, 3).
// Each tiles_launch<GEOM, E3, STAGING, COPY> below is one kernel instance.
extern "C" int strided_rev4_tiles(const void* x, void* y, int d, int geom, int ra, int rb,
                                  int staging, int copy, void* stream) {
  if (!runs_ok(d, ra, rb) || (staging != PLANE && staging != BLOCK) ||
      (geom != J2J1 && geom != J3J2) || !aligned16(x, y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)x;
  float* b = (float*)y;
  if (copy) {
    if (geom != J2J1 || staging != PLANE) return (int)cudaErrorInvalidValue;
    return (int)tiles_launch<J2J1, D, PLANE, true>(a, b, ra, rb, false, s);
  }
  if (geom == J2J1)
    return (int)(staging == PLANE ? tiles_launch<J2J1, D, PLANE, false>(a, b, ra, rb, false, s)
                                  : tiles_launch<J2J1, D, BLOCK, false>(a, b, ra, rb, false, s));
  const bool plane = staging == PLANE;
  if (ra == 8)
    return (int)(plane ? tiles_launch<J3J2, 8, PLANE, false>(a, b, ra, rb, false, s)
                       : tiles_launch<J3J2, 8, BLOCK, false>(a, b, ra, rb, false, s));
  if (ra == 16)
    return (int)(plane ? tiles_launch<J3J2, 16, PLANE, false>(a, b, ra, rb, false, s)
                       : tiles_launch<J3J2, 16, BLOCK, false>(a, b, ra, rb, false, s));
  if (ra == 64)
    return (int)(plane ? tiles_launch<J3J2, 64, PLANE, false>(a, b, ra, rb, false, s)
                       : tiles_launch<J3J2, 64, BLOCK, false>(a, b, ra, rb, false, s));
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

// rev4_async (v_dma4d): c2, the run of j2 a CTA owns (divides 64); its run of
// j1 is 16 / c2 planes long (at least 1), so a CTA transposes 16 planes
// through the ring and the grid holds 256 CTAs: rev4_tiles' J2J1 PLANE
// instance over blocks of runs (c2, j1 run), one CTA a block.
extern "C" int strided_rev4_async(const void* x, void* y, int d, int c2, void* stream) {
  if (!runs_ok(d, c2, 1) || !aligned16(x, y)) return (int)cudaErrorInvalidValue;
  const int j1n = c2 >= 16 ? 1 : 16 / c2;
  return (int)tiles_launch<J2J1, D, PLANE, false>((const float*)x, (float*)y, c2, j1n, true,
                                                  (cudaStream_t)stream);
}
