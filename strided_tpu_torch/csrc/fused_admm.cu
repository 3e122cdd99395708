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
// run inside one launch, with the iterates on chip; only the final z is
// written.
//
// What bounds it: the products, 2*B*D^2 FLOP an iteration (7.9 GFLOP at the
// main path's B = 16384, D = 200, 6 iterations), must be IEEE FP32 FMAs on
// the CUDA cores (a TF32 product misses the solver's accuracy gate, first
// input within 1e-4 of a converged f64 oracle); the device traffic (g, z0,
// z) is only 39 MB. So the design keeps the FMA pipe fed:
//
// * Register tiles. Each thread owns TM batch rows x TN consecutive
//   columns (8 x 8 at the main path's width). Per k-step it reads TM/4
//   float4 of the rhs tile and TN/4 float4 of S from shared memory and does
//   TM*TN FMAs: 64 FMAs for 4 loads. Its rows lie in float4 groups 4*WR rows
//   apart, so the lanes of a warp (WR row groups x 32/WR column groups) read
//   contiguous, conflict-free runs.
// * The operands of k-step k+1 are loaded before the FMAs of step k, so
//   shared-memory latency hides under them (the loop unrolled by 2; the
//   FMAs go column by column, alternating the row order, which ptxas
//   schedules best of the orders measured).
// * One register an output carries both iterates: v = u_rel + y, from which
//   z = clip(v) and y = v - z are the reference's values bit for bit (its
//   y is (y + u_rel) - z). With 7 warps an SM at D = 200 each thread has 255
//   registers, so g stays in registers for the tile too; the wide instance
//   (up to 16 warps) re-reads it each iteration.
// * A persistent grid: as many blocks as the card holds at once, each
//   walking batch tiles with a fixed stride. A block copies S into shared
//   memory once (16-byte cp.async) and keeps it for every tile and
//   iteration. When S does not fit beside the rhs tile it streams through a
//   two-panel cp.async ring from L2, the next panel in flight while one is
//   used.
//
// S is used as given, never assumed symmetric. The products sum over k in
// order with fmaf, as the first design did. Ragged batches (B not a
// multiple of the tile) and ragged D (columns padded to the warps' width)
// are masked, so any B >= 1 and 1 <= D <= 512 work.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxD = 512;
// The narrow instance (64-row tiles of 8 x 8 thread tiles, warps of 32
// columns, g in registers) takes D while S stays resident beside its rhs
// tile: D <= 208 in 227 KB. Wider D takes the wide instance: 16-row tiles
// of 4 x 4 thread tiles, up to 16 warps.
constexpr int kNarrowMaxD = 208;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// all of this thread's copies but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, k0 + kc) of S into buf, SP floats apart, one warp a row; one
// commit group. vec: rows are whole 16-byte runs (D % 4 == 0, S aligned).
__device__ __forceinline__ void copy_panel(float* buf, const float* S, int k0, int kc, int D,
                                           int SP, bool vec) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int kk = threadIdx.x >> 5; kk < kc; kk += nw) {
    const float* src = S + static_cast<size_t>(k0 + kk) * D;
    float* dst = buf + kk * SP;
    if (vec) {
      for (int q = lane * 4; q < D; q += 128) cp_async16(dst + q, src + q);
    } else {
      for (int c = lane; c < D; c += 32) cp_async4(dst + c, src + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Columns [c, c + 4) of a row of a (., D) array, 0 beyond D.
__device__ __forceinline__ float4 load4(const float* row, int c, int D, bool vec) {
  if (vec) return c < D ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  float t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = c + j < D ? __ldg(row + c + j) : 0.f;
  return make_float4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ float get(const float4& t, int j) {
  return j == 0 ? t.x : j == 1 ? t.y : j == 2 ? t.z : t.w;
}

// acc[i][j] += a[i] * s[j]: TM rows (TM/4 float4) by TN columns (TN/4
// float4), column by column, the row order alternating.
template <int TM, int TN>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], const float4 (&a)[TM / 4],
                                         const float4 (&b)[TN / 4]) {
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int ii = 0; ii < TM; ++ii) {
      const int i = (j & 1) ? TM - 1 - ii : ii;
      acc[i][j] = fmaf(get(a[i / 4], i % 4), get(b[j / 4], j % 4), acc[i][j]);
    }
}

// acc += rhs[rows, k] * S[k, cols] over the kc rows of one panel. a: this
// thread's first 4 rows of rhsT at the panel's first k (its next 4 lie QS
// further); s: its TN columns of the panel's first row. The operands of
// step k + 1 are loaded before the FMAs of step k.
template <int TM, int TN, int LD, int QS>
__device__ __forceinline__ void panel_fma(float (&acc)[TM][TN], const float* a, const float* s,
                                          int kc, int SP) {
  float4 ra[TM / 4], rb[TN / 4];
#pragma unroll
  for (int q = 0; q < TM / 4; ++q) ra[q] = *reinterpret_cast<const float4*>(a + q * QS);
#pragma unroll
  for (int q = 0; q < TN / 4; ++q) rb[q] = *reinterpret_cast<const float4*>(s + 4 * q);
#pragma unroll 2
  for (int kk = 1; kk < kc; ++kk) {
    a += LD;
    s += SP;
    float4 na[TM / 4], nb[TN / 4];
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) na[q] = *reinterpret_cast<const float4*>(a + q * QS);
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) nb[q] = *reinterpret_cast<const float4*>(s + 4 * q);
    fma_tile<TM, TN>(acc, ra, rb);
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) ra[q] = na[q];
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) rb[q] = nb[q];
  }
  fma_tile<TM, TN>(acc, ra, rb);
}

// The block's shape: WR row groups a warp (its lanes are WR row groups x
// 32/WR column groups), a thread's TM rows (in float4 groups QS = 4*WR rows
// apart) x TN consecutive columns. A warp owns (WR*TM) x (32/WR*TN) outputs,
// a tile BT = WR*TM batch rows by D padded to whole warps (DP columns).
// GREG: g is held in registers for the tile, else re-read each iteration.
// Tiles of 64 rows (WR = 8) are built for D <= kNarrowMaxD, others for any D.
template <int WR, int TM, int TN, bool GREG>
struct Shape {
  static constexpr int QS = 4 * WR;        // rows between a thread's float4 row groups
  static constexpr int BT = WR * TM;       // batch rows a tile
  static constexpr int LD = BT + 4;        // rhsT row stride: the pad keeps its float4 stores conflict-free
  static constexpr int WC = 32 / WR * TN;  // columns a warp
  static constexpr int MAX_D = WR == 8 ? kNarrowMaxD : kMaxD;
  static constexpr int MAX_THREADS = (MAX_D + WC - 1) / WC * 32;
};

// KS rows of S a panel (KS >= D: S resident), each SP = D rounded up to 4
// floats apart, and DP - SP floats of slack after a panel's last row, which
// the padded columns of the last row read (zero; elsewhere they read the
// next row's values: finite, and their sums are never used). vec_flags: 1 =
// S rows are 16-byte runs, 2 = so are the rows of g, z0 and out.
template <int WR, int TM, int TN, bool GREG>
__global__ void __launch_bounds__(Shape<WR, TM, TN, GREG>::MAX_THREADS, 1)
fused_admm_kernel(const float* __restrict__ g, const float* __restrict__ z0,
                  const float* __restrict__ S, const float* __restrict__ lo,
                  const float* __restrict__ hi, float* __restrict__ out, int B, int D,
                  int iters, float rho, float alpha, int KS, int vec_flags) {
  using Sh = Shape<WR, TM, TN, GREG>;
  constexpr int QS = Sh::QS, BT = Sh::BT, LD = Sh::LD;
  const int DP = (blockDim.x >> 5) * Sh::WC;  // D padded to whole warps
  const int SP = (D + 3) & ~3;
  const int pbuf = KS * SP + DP - SP;  // floats a panel buffer
  const bool resident = KS >= D;
  const int npanels = (D + KS - 1) / KS;
  const bool vS = vec_flags & 1, vIO = vec_flags & 2;
  extern __shared__ __align__(16) float smem[];
  float* rhsT = smem;           // [D][LD], rhsT[k * LD + r] = rhs[r][k]
  float* sbuf = smem + D * LD;  // [resident ? 1 : 2][pbuf]

  const int lane = threadIdx.x & 31;
  const int r0 = (lane % WR) * 4;  // this thread's rows: r0 + q*QS + [0, 4), q < TM/4
  const int c0 = (threadIdx.x >> 5) * Sh::WC + (lane / WR) * TN;  // and its TN columns

  const int nbuf = resident ? 1 : 2;
  for (int b = 0; b < nbuf; ++b)
    for (int i = KS * SP + threadIdx.x; i < pbuf; i += blockDim.x) sbuf[b * pbuf + i] = 0.f;
  // the ring's position: panels used so far; panel n % npanels sits in
  // buffer n & 1
  int used = 0;
  auto issue = [&](int n) {
    const int k0 = (n % npanels) * KS;
    copy_panel(sbuf + (n & 1) * pbuf, S, k0, min(KS, D - k0), D, SP, vS);
  };
  if (resident) {
    copy_panel(sbuf, S, 0, D, D, SP, vS);
  } else {
    issue(0);
    issue(1);
  }

  // this thread's TN columns of row r of a (., D) array (0 beyond D, or for
  // r >= B)
  const auto load_cols = [&](const float* a, int r, float (&dst)[TN], bool vec) {
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 t = r < B ? load4(a + static_cast<size_t>(r) * D, c0 + 4 * q, D, vec)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[4 * q + j] = get(t, j);
    }
  };
  const int ntiles = (B + BT - 1) / BT;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int rbase = tile * BT + r0;
    const auto row = [&](int i) { return rbase + (i >> 2) * QS + (i & 3); };
    float v[TM][TN];  // v = u_rel + y: z = clip(v), y = v - z
    float g_tile[GREG ? TM : 1][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      load_cols(z0, row(i), v[i], vIO);
      if constexpr (GREG) load_cols(g, row(i), g_tile[i], vIO);
    }

    bool first = true;  // z = z0 and y = 0 as given, not clip(v)
    for (int it = 0; it < iters; ++it) {
      // lo and hi are re-read (L1) where needed rather than held in
      // registers through the k loop
      float lo_r[TN], hi_r[TN];
      load_cols(lo, 0, lo_r, false);
      load_cols(hi, 0, hi_r, false);
      // the rhs tile, transposed: rhsT[c][r] = rho (z - y) - g
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        float gq[4][TN];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (GREG) {
#pragma unroll
            for (int j = 0; j < TN; ++j) gq[i][j] = g_tile[4 * q + i][j];
          } else {
            load_cols(g, row(4 * q + i), gq[i], vIO);
          }
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = v[4 * q + i][j];
            const float z = first ? x : fminf(fmaxf(x, lo_r[j]), hi_r[j]);
            const float y = first ? 0.f : x - z;
            r[i] = rho * (z - y) - gq[i][j];
          }
          if (c0 + j < D)
            *reinterpret_cast<float4*>(rhsT + (c0 + j) * LD + r0 + q * QS) =
                make_float4(r[0], r[1], r[2], r[3]);
        }
      }

      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int p = 0; p < npanels; ++p) {
        if (resident) {
          cp_async_wait<0>();
        } else {
          cp_async_wait<1>();  // the older of the two panels in flight
        }
        __syncthreads();  // the panel and the rhs tile are complete
        const int k0 = p * KS;
        const float* buf = sbuf + (resident ? 0 : (used & 1) * pbuf);
        panel_fma<TM, TN, LD, QS>(acc, rhsT + k0 * LD + r0, buf + c0, min(KS, D - k0), SP);
        __syncthreads();  // reads done before the buffer or the rhs tile is rewritten
        if (!resident) issue(++used + 1);
      }

      load_cols(lo, 0, lo_r, false);
      load_cols(hi, 0, hi_r, false);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float z = first ? v[i][j] : fminf(fmaxf(v[i][j], lo_r[j]), hi_r[j]);
          const float y = first ? 0.f : v[i][j] - z;
          const float u_rel = alpha * acc[i][j] + (1.f - alpha) * z;
          v[i][j] = u_rel + y;
        }
      first = false;
    }

    float lo_r[TN], hi_r[TN];
    load_cols(lo, 0, lo_r, false);
    load_cols(hi, 0, hi_r, false);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (row(i) >= B) continue;
      float z[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) z[j] = first ? v[i][j] : fminf(fmaxf(v[i][j], lo_r[j]), hi_r[j]);
      float* dst = out + static_cast<size_t>(row(i)) * D;
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int c = c0 + 4 * q;
        if (vIO) {
          if (c < D)
            *reinterpret_cast<float4*>(dst + c) =
                make_float4(z[4 * q], z[4 * q + 1], z[4 * q + 2], z[4 * q + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < D) dst[c + j] = z[4 * q + j];
        }
      }
    }
  }
  cp_async_wait<0>();  // the ring's last prefetches land before the block exits
}

// Per device and template instance, once: the opt-in shared-memory limit,
// raised for the kernel (above 48 KB a launch is refused unless it is), and
// the SM count. Nothing here runs again on later launches, so a launch
// inside a CUDA graph capture does no set-up.
struct Setup {
  bool ready = false;
  int max_smem = 0;
  int sms = 0;
};

template <int WR, int TM, int TN, bool GREG>
cudaError_t setup(int dev, const Setup** out) {
  static Setup table[kMaxDevices];
  static std::mutex mu;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Setup& s = table[dev];
  if (!s.ready) {
    cudaError_t err = cudaDeviceGetAttribute(&s.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_admm_kernel<WR, TM, TN, GREG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, s.max_smem);
    if (err != cudaSuccess) return err;
    s.ready = true;
  }
  *out = &s;
  return cudaSuccess;
}

template <int WR, int TM, int TN, bool GREG>
cudaError_t launch(const float* g, const float* z0, const float* S, const float* lo,
                   const float* hi, float* out, int B, int D, int iters, float rho, float alpha,
                   int panel_rows, cudaStream_t stream) {
  using Sh = Shape<WR, TM, TN, GREG>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Setup* s = nullptr;
  err = setup<WR, TM, TN, GREG>(dev, &s);
  if (err != cudaSuccess) return err;
  const int ncw = (D + Sh::WC - 1) / Sh::WC;  // warps
  if (D > Sh::MAX_D) return cudaErrorInvalidValue;
  const size_t SP = (D + 3) & ~3, slack = ncw * Sh::WC - SP;
  const size_t avail = static_cast<size_t>(s->max_smem);
  const size_t rhs_bytes = sizeof(float) * D * Sh::LD;
  // S resident, unless it does not fit or fewer panel rows are asked for
  size_t KS = D;
  if (rhs_bytes + sizeof(float) * (D * SP + slack) > avail || (panel_rows > 0 && panel_rows < D)) {
    if (avail < rhs_bytes + 2 * sizeof(float) * (SP + slack)) return cudaErrorInvalidValue;
    KS = std::min<size_t>(D - 1, ((avail - rhs_bytes) / (2 * sizeof(float)) - slack) / SP);
    if (panel_rows > 0) KS = std::min<size_t>(KS, panel_rows);
  }
  const size_t nbuf = KS >= static_cast<size_t>(D) ? 1 : 2;
  const size_t smem = rhs_bytes + nbuf * sizeof(float) * (KS * SP + slack);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_admm_kernel<WR, TM, TN, GREG>,
                                                      ncw * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ntiles = (B + Sh::BT - 1) / Sh::BT;
  const int grid = std::min(ntiles, per_sm * s->sms);
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool rows16 = D % 4 == 0;
  const int vec_flags = (rows16 && a16(S) ? 1 : 0) | (rows16 && a16(g) && a16(z0) && a16(out) ? 2 : 0);
  fused_admm_kernel<WR, TM, TN, GREG><<<grid, ncw * 32, smem, stream>>>(
      g, z0, S, lo, hi, out, B, D, iters, rho, alpha, static_cast<int>(KS), vec_flags);
  return cudaGetLastError();
}

// The kernel's own choice of instance for the width.
cudaError_t dispatch(const float* g, const float* z0, const float* S, const float* lo,
                     const float* hi, float* out, int B, int D, int iters, float rho, float alpha,
                     int panel_rows, cudaStream_t s) {
  if (D <= kNarrowMaxD)
    return launch<8, 8, 8, true>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
  return launch<4, 4, 4, false>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
}

bool valid(int B, int D, int iters, int panel_rows) {
  return B >= 1 && D >= 1 && D <= kMaxD && iters >= 0 && panel_rows >= 0;
}

}  // namespace

// All pointers are device pointers to contiguous f32 arrays: g, z0 and out
// (B, D); S (D, D); lo and hi (D,). Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int strided_fused_admm_f32(const float* g, const float* z0, const float* S,
                                      const float* lo, const float* hi, float* out, int B, int D,
                                      int iters, float rho, float alpha, void* stream) {
  if (!valid(B, D, iters, 0)) return cudaErrorInvalidValue;
  return dispatch(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, 0,
                  static_cast<cudaStream_t>(stream));
}

// The tile designs this one was chosen over, for the probe script
// benchmarks/exp_admm.py (none is on the main path): 0 = the kernel's own
// choice, as strided_fused_admm_f32; 1 = 8 x 4 thread tiles, 13 warps at
// D = 200, g re-read; 2 = the same with g in registers (it spills at 128
// registers); 3 = 8 x 8 tiles, g re-read; 4 = the wide instance's 16-row
// tiles of 4 x 4 at any D. panel_rows > 0 streams S through the ring in
// panels of at most that many rows even where it would fit whole.
extern "C" int strided_fused_admm_design_f32(const float* g, const float* z0, const float* S,
                                             const float* lo, const float* hi, float* out, int B,
                                             int D, int iters, float rho, float alpha,
                                             int panel_rows, int design, void* stream) {
  if (!valid(B, D, iters, panel_rows)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 0:
      return dispatch(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
    case 1:
      return launch<8, 8, 4, false>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
    case 2:
      return launch<8, 8, 4, true>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
    case 3:
      return launch<8, 8, 8, false>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
    case 4:
      return launch<4, 4, 4, false>(g, z0, S, lo, hi, out, B, D, iters, rho, alpha, panel_rows, s);
  }
  return cudaErrorInvalidValue;
}
