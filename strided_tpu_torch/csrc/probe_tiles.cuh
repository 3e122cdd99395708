// Shared by the probe kernels (exp_sym.cu, exp_pair_rect.cu): a 32 x 8
// thread block walking an R x C tile.
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

}  // namespace probe
