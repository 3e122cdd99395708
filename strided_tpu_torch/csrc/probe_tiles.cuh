// Shared by the probe kernels (exp_sym.cu, exp_pair_rect.cu, exp_perm.cu):
// a 32 x 8 thread block walking an R x C tile, and a ring of 16-byte
// cp.async copies of rows into shared memory.
#pragma once

namespace probe {

constexpr int TX = 32, TY = 8;  // 256 threads a block

// f(r, c) for every element of an R x C tile, thread (x, y) taking rows
// y, y + 8, ... and columns x, x + 32, .... The trip counts are constants,
// so nvcc unrolls both loops and a thread issues all its global loads before
// the first dependent store; loops starting at threadIdx (unknown trip count)
// issued them one at a time and took 38% longer on an H100 (PERF.md).
template <int R, int C, typename F>
__device__ __forceinline__ void for_tile(F f) {
  static_assert(R % TY == 0 && C % TX == 0, "tile not a multiple of the block");
#pragma unroll
  for (int r = 0; r < R; r += TY)
#pragma unroll
    for (int c = 0; c < C; c += TX) f(r + (int)threadIdx.y, c + (int)threadIdx.x);
}

// (a + b) * 0.5, uncontracted: equal to PyTorch's eager (a + a.T) * 0.5.
__device__ __forceinline__ float sym(float a, float b) { return __fmul_rn(__fadd_rn(a, b), 0.5f); }

// --------------------------------------------------------------------------
// The cp.async ring: stages of ROWS rows of W floats (W a multiple of 8) at
// a pitch of W + 4: rows start 16-byte aligned for cp.async, and rows 4
// apart lie 16 banks apart, which a 4 x 4 sub-block lane map uses to read
// float4s without bank conflicts (exp_perm.cu::sub_block).
template <int W>
constexpr int ring_pitch = W + 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // wait until at most N of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage <- ROWS rows of W floats, row r of pass p from src(p, r): W / 4
// threads a row, a constant trip count, one commit group.
template <int ROWS, int W, int THREADS, class Src>
__device__ __forceinline__ void ring_fill(float* stage, const Src& src, int p) {
  static_assert(ROWS * W / 4 % THREADS == 0, "a stage is whole rounds of the block");
#pragma unroll
  for (int k = 0; k < ROWS * W / 4 / THREADS; ++k) {
    const int idx = threadIdx.x + k * THREADS, r = idx / (W / 4), c = idx % (W / 4) * 4;
    cp_async16(stage + r * ring_pitch<W> + c, src(p, r) + c);
  }
  cp_async_commit();
}

// passes stages through a ring of STAGES: use(stage, p) runs while the
// copies of the next STAGES - 1 passes are in flight. One barrier a pass:
// it publishes pass p's rows and frees the stage of pass p - 1, which the
// fill right after it reuses.
template <int STAGES, int ROWS, int W, int THREADS, class Src, class Use>
__device__ __forceinline__ void ring_run(float* ring, int passes, const Src& src, const Use& use) {
  static_assert(STAGES >= 2, "a fill overlaps a use");
  constexpr int STAGE = ROWS * ring_pitch<W>;
  for (int p = 0; p < STAGES - 1 && p < passes; ++p)
    ring_fill<ROWS, W, THREADS>(ring + p * STAGE, src, p);
  for (int p = 0; p < passes; ++p) {
    if (p + STAGES - 2 < passes) cp_async_wait<STAGES - 2>();
    else cp_async_wait<0>();
    __syncthreads();
    const int f = p + STAGES - 1;
    if (f < passes) ring_fill<ROWS, W, THREADS>(ring + f % STAGES * STAGE, src, f);
    use(ring + p % STAGES * STAGE, p);
  }
}

}  // namespace probe
