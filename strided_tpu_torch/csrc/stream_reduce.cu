// K3: the streaming reduction, out[c] = fold over r of f(A)[r, c].
//
// Replaces the Pallas kernel strided_tpu/core/kernels_special.py::
// _make_stream_reduce_kernel (driven by _stream_reduce_2d): a partial
// reduction of a dense operand whose reduced axes are the leading physical
// block, seen as an (N, M) matrix with the kept axes as its minor dim M.
// The fold is sum, prod, min or max; f is an elementwise program
// (ewise.cuh) applied to each element before the fold.
//
// What bounds it on an H100: bytes. The kernel reads N * M elements once
// and writes M; at 8192^2 f32 that is 268 MB against 3.35 TB/s.
//
// Design, shaped for 132 SMs:
// - The work is (column block, row chunk) items, one CTA each, numbered
//   column block fastest. core/stream_reduce.py::row_chunks picks the split
//   from the shape alone: no more items than 132 SMs x the resident CTAs
//   (__launch_bounds__: 4 an SM, 2 for a program), so every CTA starts in
//   the one wave and
//   the chunks are as tall as that allows; a chunk is a whole number of
//   64-row steps, only the last one ragged. The chunks' partials are folded
//   in chunk order in the same launch, by the block of each column block
//   that finishes last (a ticket elects it; finish_block): deterministic,
//   and no second kernel, whose launch cost an eager caller as much as the
//   kernel had gained (PERF.md).
// - Each thread keeps eight loads in flight a step. The identity program
//   (a plain sum, min ...) takes reduce_identity, a kernel for each fold,
//   element type and width: a thread owns 8 columns, read with 16-byte
//   loads (two per row for 4-byte types, one for bf16), and folds with no
//   interpreter and no run-time switch. Unaligned rows (M not a multiple of
//   16 bytes) take the same kernel with one column a thread.
// - Any other program takes reduce_program: a thread owns one column, loads
//   8 rows, runs the program once over the 8 values with the amortized
//   interpreter (ew_run_v), and folds them in row order; a program wider
//   than EW_CREG registers runs the scalar interpreter instead.
// - The 8 row lanes of a CTA are merged in lane order through shared
//   memory. Accumulates in f32 for f32/bf16 values and in int32 for int32,
//   and rounds once to the result type.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ewise.cuh"

namespace {

constexpr int COLS = 32;   // lanes of columns (blockDim.x)
constexpr int LANES = 8;   // row lanes (blockDim.y)
constexpr int THREADS = COLS * LANES;
constexpr int STEP = 64;   // rows a chunk is a multiple of (stream_reduce.py: STEP)
constexpr int NV = 8;      // columns a thread owns on the vector path

// Column (within the block) of a thread's value v.
template <int LT, bool VEC>
__device__ __forceinline__ int col_of(int lane, int v) {
  if (!VEC) return lane;
  if (LT == EW_BF16) return lane * 8 + v;
  return (v / 4) * (COLS * 4) + lane * 4 + (v % 4);  // two 512-byte runs a warp
}

__device__ __forceinline__ EwVal bits(uint32_t u) {
  EwVal v;
  v.i = (int32_t)u;
  return v;
}

__device__ __forceinline__ EwVal bf16_bits(uint32_t h) { return bits(h << 16); }

// The raw words of a thread's values in one row (p: the row's first
// column of the block): 8 words (two 16-byte loads) for a 4-byte type, 4
// (one) for bf16 on the vector path; one word otherwise.
template <int LT, bool VEC, int NW>
__device__ __forceinline__ void load_words(const char* p, int lane, bool second, uint32_t* w) {
  if constexpr (!VEC) {
    w[0] = LT == EW_BF16 ? (uint32_t)__ldg((const unsigned short*)p + lane)
                         : __ldg((const uint32_t*)p + lane);
  } else {
#pragma unroll
    for (int g = 0; g < NW / 4; ++g) {
      if (g == 1 && !second) continue;  // only the first 512-byte run is in range
      const uint4 q = __ldg((const uint4*)p + g * COLS + lane);
      w[4 * g] = q.x;
      w[4 * g + 1] = q.y;
      w[4 * g + 2] = q.z;
      w[4 * g + 3] = q.w;
    }
  }
}

// Value v of a thread's words.
template <int LT, bool VEC>
__device__ __forceinline__ EwVal word_value(const uint32_t* w, int v) {
  if (LT != EW_BF16) return bits(w[v]);
  if (!VEC) return bf16_bits(w[0]);
  return bf16_bits(v % 2 ? w[v / 2] >> 16 : w[v / 2] & 0xffffu);
}

// Merge the 8 row lanes' partials of the block's cpb columns in lane order.
// One chunk: write the result. Several: write the chunk's partial, then
// take a ticket of the column block; the block holding its last ticket
// folds the chunks' partials in chunk order and writes the result. The
// ticket picks which block folds, never the order of the folds, so the
// result is deterministic; atomicInc wraps the ticket back to 0 for the
// next launch on the stream.
template <typename Merge>
__device__ __forceinline__ void finish_block(EwVal (&part)[LANES][COLS * NV], int cpb,
                                             int64_t col0, int64_t M, int col_blocks, void* out,
                                             EwVal* scratch, unsigned* tickets, int out_t,
                                             Merge merge) {
  __shared__ bool last;
  __syncthreads();
  const int t = threadIdx.y * COLS + threadIdx.x;
  const int64_t col = col0 + t;
  const bool mine = t < cpb && col < M;
  EwVal a;
  if (mine) {
    a = part[0][t];
#pragma unroll
    for (int l = 1; l < LANES; ++l) a = merge(a, part[l][t]);
  }
  const unsigned chunks = gridDim.x / col_blocks;
  if (chunks == 1) {
    if (mine) ew_store(out, col, out_t, a);
    return;
  }
  if (mine) scratch[(int64_t)(blockIdx.x / col_blocks) * M + col] = a;
  __threadfence();  // the partial is visible to every block before the ticket is taken
  __syncthreads();
  if (t == 0) last = atomicInc(tickets + blockIdx.x % col_blocks, chunks - 1) == chunks - 1;
  __syncthreads();
  if (!last || !mine) return;
  __threadfence();
  const int32_t* s = (const int32_t*)scratch;
  EwVal acc = bits(__ldcg(s + col));  // from L2: other blocks wrote them
  for (unsigned k0 = 1; k0 < chunks; k0 += 8) {
    uint32_t w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)  // 8 loads in flight, then 8 folds in chunk order
      if (k0 + u < chunks) w[u] = __ldcg(s + (int64_t)(k0 + u) * M + col);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < chunks) acc = merge(acc, bits(w[u]));
  }
  ew_store(out, col, out_t, acc);
}

// The identity program: fold RED over elements of type LT.
template <int RED, int LT, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
reduce_identity(const void* __restrict__ in, void* __restrict__ out, EwVal* __restrict__ scratch,
                unsigned* __restrict__ tickets, int64_t N, int64_t M, int64_t rows,
                int col_blocks) {
  constexpr bool FL = LT != EW_I32;
  constexpr int NT = VEC ? NV : 1;                    // columns a thread owns
  constexpr int NW = !VEC ? 1 : LT == EW_BF16 ? 4 : 8;  // 32-bit words of them a row
  constexpr int ROWS = (VEC && LT != EW_BF16) ? 4 : 8;  // rows a step: 8 loads
  constexpr int ESZ = LT == EW_BF16 ? 2 : 4;
  __shared__ EwVal part[LANES][COLS * NV];
  const int lane = threadIdx.x;
  const int64_t col0 = (int64_t)(blockIdx.x % col_blocks) * COLS * NT;
  const int64_t chunk = blockIdx.x / col_blocks;
  const int64_t r0 = chunk * rows, r1 = r0 + rows < N ? r0 + rows : N;
  // a vector thread's 16-byte groups are whole (M is a multiple of 16
  // bytes), so a group is in range if its first column is
  const bool live = col0 + col_of<LT, VEC>(lane, 0) < M;
  const bool second = col0 + col_of<LT, VEC>(lane, NT - 1) < M;
  EwVal acc[NT];
#pragma unroll
  for (int v = 0; v < NT; ++v) acc[v] = ew_identity_t<RED, FL>();
  const char* base = (const char*)in + col0 * ESZ;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += ROWS * LANES) {
    uint32_t w[ROWS][NW] = {};
#pragma unroll
    for (int u = 0; u < ROWS; ++u)  // every load of the step, then every fold
      if (r + u * LANES < r1 && live)
        load_words<LT, VEC, NW>(base + (r + u * LANES) * M * ESZ, lane, second, w[u]);
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      if (r + u * LANES < r1)
#pragma unroll
        for (int v = 0; v < NT; ++v)
          acc[v] = ew_fold_t<RED, FL>(acc[v], word_value<LT, VEC>(w[u], v));
  }
#pragma unroll
  for (int v = 0; v < NT; ++v) part[threadIdx.y][col_of<LT, VEC>(lane, v)] = acc[v];
  finish_block(part, COLS * NT, col0, M, col_blocks, out, scratch, tickets, LT,
               [](EwVal a, EwVal b) { return ew_fold_t<RED, FL>(a, b); });
}

// Fold the values v[0 .. n) (rows in order) into acc.
template <bool FL>
__device__ __forceinline__ EwVal fold_rows(int red, EwVal acc, const EwVal* v, int n) {
  switch (red) {
#define FOLD_CASE(RED)                                                       \
  case RED:                                                                  \
    _Pragma("unroll") for (int u = 0; u < 8; ++u) if (u < n) acc = ew_fold_t<RED, FL>(acc, v[u]); \
    return acc;
    FOLD_CASE(EW_RED_SUM) FOLD_CASE(EW_RED_PROD) FOLD_CASE(EW_RED_MIN) FOLD_CASE(EW_RED_MAX)
#undef FOLD_CASE
  }
  return acc;
}

// Any other program: one column a thread, 8 rows a step, the program run
// once over the 8 values with R registers (FL: float results; R = 0: the
// body needs more than EW_CREG, the scalar interpreter on each value), the
// next step's loads in flight meanwhile.
template <bool FL, int R>
__global__ void __launch_bounds__(THREADS, 2)
reduce_program(const void* __restrict__ in, void* __restrict__ out, EwVal* __restrict__ scratch,
               unsigned* __restrict__ tickets, int64_t N, int64_t M, int64_t rows, int col_blocks,
               int red,
               const __grid_constant__ EwProgram prog) {
  constexpr int ROWS = 8;
  __shared__ EwVal part[LANES][COLS * NV];
  const int lane = threadIdx.x;
  const int lt = prog.in_type[0];
  const int64_t col0 = (int64_t)(blockIdx.x % col_blocks) * COLS;
  const int64_t chunk = blockIdx.x / col_blocks;
  const int64_t r0 = chunk * rows, r1 = r0 + rows < N ? r0 + rows : N;
  const int64_t col = col0 + lane;
  EwVal acc = ew_red_identity(red, FL ? EW_F32 : EW_I32);
  // software-pipelined: the next step's 8 loads are issued before this
  // step's values are interpreted, so they stay in flight meanwhile
  auto load_step = [&](int64_t r, EwVal* x) {
    int64_t idx[ROWS];
    bool ok[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      x[u] = bits(0);
      ok[u] = r + u * LANES < r1 && col < M;
      idx[u] = (r + u * LANES) * M + col;
    }
    ew_load_v<ROWS>(in, idx, ok, lt, x);
  };
  EwVal cur[ROWS];
  load_step(r0 + threadIdx.y, cur);
  for (int64_t r = r0 + threadIdx.y; r < r1; r += ROWS * LANES) {
    EwVal next[ROWS];
    load_step(r + ROWS * LANES, next);
    const int64_t left = (r1 - r + LANES - 1) / LANES;
    const int n = left < ROWS ? (int)left : ROWS;  // rows of this step in range
    EwVal v[ROWS];
    if constexpr (R == 0) {
#pragma unroll 1
      for (int u = 0; u < ROWS; ++u) {
        EwVal rr[EW_MAX_REG];
        rr[0] = cur[u];
        v[u] = ew_run(prog, rr);
      }
    } else {
      EwVal reg[R][ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) reg[0][u] = cur[u];
      ew_run_v(prog, reg);
      ew_reg(reg, prog.out, v);
    }
    acc = fold_rows<FL>(red, acc, v, n);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) cur[u] = next[u];
  }
  part[threadIdx.y][lane] = acc;
  finish_block(part, COLS, col0, M, col_blocks, out, scratch, tickets, prog.out_type,
               [red](EwVal a, EwVal b) { return ew_red_merge(red, FL ? EW_F32 : EW_I32, a, b); });
}

typedef void (*IdentityKernel)(const void*, void*, EwVal*, unsigned*, int64_t, int64_t, int64_t,
                               int);

template <int RED, int LT>
IdentityKernel identity_kernel(bool vec) {
  return vec ? reduce_identity<RED, LT, true> : reduce_identity<RED, LT, false>;
}

template <int RED>
IdentityKernel pick_identity(int lt, bool vec) {
  if (lt == EW_F32) return identity_kernel<RED, EW_F32>(vec);
  if (lt == EW_BF16) return identity_kernel<RED, EW_BF16>(vec);
  return identity_kernel<RED, EW_I32>(vec);
}

}  // namespace

// in: (N, M) dense, of the program's leaf type; out: (M,) of its result
// type. When chunks > 1: scratch holds chunks * M 4-byte values, and
// tickets n_tickets >= the column blocks, 0 at the launch and 0 again after
// it (one buffer per stream: launches on a stream run one after another).
// The split (chunks of ``rows`` rows, vec: 8 columns a thread) comes from
// core/stream_reduce.py; vec is for the identity program only. *path is
// set to the kernel launched: 0 reduce_identity, 1 reduce_program on the
// amortized interpreter, 2 on the scalar one.
extern "C" int strided_stream_reduce(const void* in, void* out, void* scratch, void* tickets,
                                     int n_tickets, int64_t N, int64_t M, int chunks, int64_t rows,
                                     int vec, int red, const EwProgram* prog, void* stream,
                                     int* path) {
  const int lt = prog->in_type[0];
  const bool identity = prog->n_instr == 0;
  const int64_t align = lt == EW_BF16 ? 8 : 4;  // elements in 16 bytes
  if (N < 1 || M < 1 || chunks < 1 || rows < 1 || rows % STEP != 0 ||
      (int64_t)chunks * rows < N || (int64_t)(chunks - 1) * rows >= N ||
      (vec != 1 && vec != NV) || red < EW_RED_SUM || red > EW_RED_MAX ||
      prog->n_reg < 1 || prog->n_reg > EW_MAX_REG ||
      (vec == NV && (!identity || M % align != 0 || ((uintptr_t)in & 15))))
    return (int)cudaErrorInvalidValue;
  const int64_t col_blocks = (M + COLS * vec - 1) / (COLS * vec);
  if (col_blocks * chunks > 0x7fffffffLL ||
      (chunks > 1 && (scratch == nullptr || tickets == nullptr || col_blocks > n_tickets)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(col_blocks * chunks);
  const dim3 block(COLS, LANES);
  EwVal* sc = (EwVal*)scratch;
  unsigned* tk = (unsigned*)tickets;
  if (identity) {
    IdentityKernel k = red == EW_RED_SUM    ? pick_identity<EW_RED_SUM>(lt, vec == NV)
                       : red == EW_RED_PROD ? pick_identity<EW_RED_PROD>(lt, vec == NV)
                       : red == EW_RED_MIN  ? pick_identity<EW_RED_MIN>(lt, vec == NV)
                                            : pick_identity<EW_RED_MAX>(lt, vec == NV);
    k<<<grid, block, 0, s>>>(in, out, sc, tk, N, M, rows, (int)col_blocks);
    *path = 0;
  } else {
    const bool fl = ew_is_float(prog->out_type);
    const int regs = prog->n_reg;
    auto k = fl ? (regs <= 2 ? reduce_program<true, 2> : regs <= EW_CREG ? reduce_program<true, 4>
                                                                         : reduce_program<true, 0>)
                : (regs <= 2 ? reduce_program<false, 2> : regs <= EW_CREG ? reduce_program<false, 4>
                                                                          : reduce_program<false, 0>);
    k<<<grid, block, 0, s>>>(in, out, sc, tk, N, M, rows, (int)col_blocks, red, *prog);
    *path = regs <= EW_CREG ? 1 : 2;
  }
  return (int)cudaGetLastError();
}
