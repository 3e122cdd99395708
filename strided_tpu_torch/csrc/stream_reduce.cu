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
//   from the shape alone: no more items than 132 SMs x the CTAs an SM the
//   kernel keeps resident (IDENTITY_BLOCKS, program_blocks: its
//   __launch_bounds__, reported by strided_stream_reduce_shape), so every
//   CTA starts in the one wave and
//   the chunks are as tall as that allows; a chunk is a whole number of
//   64-row steps, only the last one ragged. The chunks' partials are folded
//   in chunk order in the same launch, by the block of each column block
//   that finishes last (a ticket elects it; finish_block): deterministic,
//   and no second kernel, whose launch cost an eager caller as much as the
//   kernel had gained (PERF.md).
// - A thread owns 8 columns, read with 16-byte loads (two per row for
//   4-byte types, one for bf16), wherever the rows are whole 16-byte runs
//   on an aligned base; else one column a thread, with 4- or 2-byte loads.
// - The identity program (a plain sum, min ...) takes reduce_identity, a
//   kernel for each fold, element type and width: eight loads in flight a
//   thread, then the folds, with no interpreter and no run-time switch.
// - Any other program takes reduce_program, a kernel for each register
//   file (2 or 4 registers, 1 too on 8 columns a thread, or none: the
//   scalar interpreter ew_run for bodies wider than EW_CREG), result kind
//   (float or int) and width. The program runs once over a thread's values
//   with operands picked by selects (ew_run_s) on 1 or 2 registers and
//   copied behind branches (ew_run_v) on 4. On 8 columns a thread the
//   kernel copies raw 16-byte words, which do not depend on the leaf type,
//   into a ring in shared memory with cp.async, rows ahead of the program,
//   decodes them once a row, runs the program over one or two rows' values
//   and folds each value into its column. On one column a thread it loads 8
//   rows, runs the program over them and folds them in row order, the next
//   8 rows' loads in flight meanwhile.
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

// Blocks an SM each kernel keeps resident: its __launch_bounds__ promise
// them, and launch_shape sizes one wave of a launch from them. The identity
// kernels 4; a program kernel 3 on 8 columns a thread, where its register
// file fits 80 registers, and 2 with 4 registers (at 80 they spill) or on
// one column a thread.
constexpr int IDENTITY_BLOCKS = 4;
constexpr int program_blocks(int r, bool vec) { return vec && r != 4 ? 3 : 2; }

// The register file of a program of n_reg registers: 1 (8 columns a thread
// only), 2 or 4 (interpret), or 0 for the scalar interpreter (a body wider
// than EW_CREG).
constexpr int register_file(int n_reg, bool vec) {
  return n_reg == 1 && vec ? 1 : n_reg <= 2 ? 2 : n_reg <= EW_CREG ? 4 : 0;
}

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
__global__ void __launch_bounds__(THREADS, IDENTITY_BLOCKS)
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

// Fold v(c) into acc[c], for each of a thread's NV columns.
template <bool FL, typename V>
__device__ __forceinline__ void fold_cols(int red, EwVal* acc, V v) {
  switch (red) {
#define FOLD_CASE(RED)                                                        \
  case RED:                                                                   \
    _Pragma("unroll") for (int c = 0; c < NV; ++c) acc[c] = ew_fold_t<RED, FL>(acc[c], v(c)); \
    return;
    FOLD_CASE(EW_RED_SUM) FOLD_CASE(EW_RED_PROD) FOLD_CASE(EW_RED_MIN) FOLD_CASE(EW_RED_MAX)
#undef FOLD_CASE
  }
}

// The program once over a register file of R registers, E values each (the
// leaves in reg[0], the result left in reg[prog.out]): operands picked by
// selects (ew_run_s) for 1 or 2 registers, copied behind branches (ew_run_v)
// for 4, where a 4-way select per operand and value costs more (PERF.md).
template <int R, int E>
__device__ __forceinline__ void interpret(const EwProgram& prog, EwVal (&reg)[R][E]) {
  if constexpr (R == 4) ew_run_v(prog, reg);
  else ew_run_s(prog, reg);
}

// The program on 8 leaf values x, results in y: once over all 8 with R
// registers, or (R = 0: a body wider than EW_CREG) the scalar interpreter
// on each value.
template <int R>
__device__ __forceinline__ void run_program(const EwProgram& prog, const EwVal* x, EwVal* y) {
  if constexpr (R == 0) {
#pragma unroll 1
    for (int u = 0; u < 8; ++u) {
      EwVal rr[EW_MAX_REG];
      rr[0] = x[u];
      y[u] = ew_run(prog, rr);
    }
  } else {
    EwVal reg[R][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) reg[0][u] = x[u];
    interpret(prog, reg);
#pragma unroll
    for (int u = 0; u < 8; ++u) y[u] = ew_sel(reg, prog.out, u);
  }
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, LDGSTS); zero-fills the 16 bytes instead of reading where !ok.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // wait until at most N of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows of a vector program kernel's shared-memory ring: 32 KB, so with the
// 8 KB of partials a block stays under the 48 KB of static shared memory.
// A ring of 8 rows (64 KB, dynamic) was slower (PERF.md).
constexpr int RING_ROWS = 4;

// Eight columns a thread on a ring of RING_ROWS rows in shared memory: a
// thread copies its 16-byte words of a row (two for a 4-byte leaf, one for
// bf16; raw words, whatever the leaf type) with cp.async, up to RING_ROWS
// rows ahead, and reads back only its own words, so no barrier is needed. Each
// turn takes RUN rows out of the ring (RUN = 2 for bodies of one register,
// so the program runs once over 16 values; else 1), decodes the
// leaf type, runs the program (interpret; R = 0: the scalar interpreter on
// each value), folds each row's values into their columns in
// row order, and sends the copies of the rows one ring further on. The
// loads cost no registers and the program one copy of its code.
template <bool FL, int R>
__device__ __forceinline__ void program_vector(const void* in, int64_t M, int64_t r0, int64_t r1,
                                               int64_t col0, int red, const EwProgram& prog,
                                               uint4* ring, EwVal (&part)[LANES][COLS * NV]) {
  constexpr int RUN = R == 1 ? 2 : 1;  // rows a turn
  constexpr int SLOTS = RING_ROWS / RUN;           // turns of rows in the ring
  constexpr int RF = R == 0 ? 1 : R;               // registers of the file
  const int lane = threadIdx.x;
  const int t = threadIdx.y * COLS + lane;
  const bool bf = prog.in_type[0] == EW_BF16;
  const int64_t esz = bf ? 2 : 4;
  const int64_t pitch = M * esz;  // bytes a row
  // a 16-byte group is whole (M is a multiple of 16 bytes), so it is in
  // range if its first column is
  const bool live = col0 + lane * (bf ? 8 : 4) < M;
  const bool two = !bf && col0 + COLS * 4 + lane * 4 < M;  // a 4-byte leaf's second run
  const char* base = (const char*)in + col0 * esz + lane * 16;
  auto send = [&](int64_t r, int slot) {  // the copies of rows r, r + LANES .. into a slot
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      const int64_t row = r + u * LANES;
      const bool ok = row < r1 && live;
      const char* p = ok ? base + row * pitch : base;
      uint4* w = ring + ((slot * RUN + u) * 2) * THREADS + t;
      cp_async16(w, p, ok);
      if (!bf) cp_async16(w + THREADS, two ? p + COLS * 16 : p, ok && two);
    }
    cp_async_commit();
  };
  const int64_t ry = r0 + threadIdx.y;
#pragma unroll
  for (int k = 0; k < SLOTS - 1; ++k) send(ry + k * RUN * LANES, k);
  EwVal acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = ew_red_identity(red, FL ? EW_F32 : EW_I32);
  int slot = 0;
#pragma unroll 1
  for (int64_t r = ry; r < r1; r += RUN * LANES) {
    send(r + (SLOTS - 1) * RUN * LANES, slot == 0 ? SLOTS - 1 : slot - 1);
    cp_async_wait<SLOTS - 1>();  // this turn's rows have landed
    EwVal reg[RF][RUN * NV];
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      const uint4* w = ring + ((slot * RUN + u) * 2) * THREADS + t;
      const uint4 q = w[0];
      if (bf) {
        const uint32_t h[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int c = 0; c < NV; ++c)
          reg[0][u * NV + c] = bf16_bits(c % 2 ? h[c / 2] >> 16 : h[c / 2] & 0xffffu);
      } else {
        const uint4 q2 = w[THREADS];
        const uint32_t h[8] = {q.x, q.y, q.z, q.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
        for (int c = 0; c < NV; ++c) reg[0][u * NV + c] = bits(h[c]);
      }
    }
    if constexpr (R == 0) {
      EwVal y[NV];
      run_program<0>(prog, reg[0], y);
      fold_cols<FL>(red, acc, [&](int c) { return y[c]; });
    } else {
      interpret(prog, reg);
#pragma unroll
      for (int u = 0; u < RUN; ++u)
        if (r + u * LANES < r1)
          fold_cols<FL>(red, acc, [&](int c) { return ew_sel(reg, prog.out, u * NV + c); });
    }
    slot = slot + 1 == SLOTS ? 0 : slot + 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int c = 0; c < NV; ++c)
    part[threadIdx.y][bf ? lane * 8 + c : (c / 4) * (COLS * 4) + lane * 4 + c % 4] = acc[c];
}

// One column a thread (rows that are not whole 16-byte runs, or an
// unaligned base): 8 rows a step, the program run once over the 8 values
// and folded in row order, the next step's loads in flight meanwhile.
template <bool FL, int R>
__device__ __forceinline__ void program_column(const void* in, int64_t M, int64_t r0, int64_t r1,
                                               int64_t col0, int red, const EwProgram& prog,
                                               EwVal (&part)[LANES][COLS * NV]) {
  constexpr int ROWS = 8;
  const int lane = threadIdx.x;
  const int lt = prog.in_type[0];
  const int64_t col = col0 + lane;
  EwVal acc = ew_red_identity(red, FL ? EW_F32 : EW_I32);
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
    run_program<R>(prog, cur, v);
    acc = fold_rows<FL>(red, acc, v, n);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) cur[u] = next[u];
  }
  part[threadIdx.y][lane] = acc;
}

// Any other program, with R registers (FL: float results; R = 0: the
// scalar interpreter), on 8 columns a thread (VEC) or one.
template <bool FL, int R, bool VEC>
__global__ void __launch_bounds__(THREADS, program_blocks(R, VEC))
reduce_program(const void* __restrict__ in, void* __restrict__ out, EwVal* __restrict__ scratch,
               unsigned* __restrict__ tickets, int64_t N, int64_t M, int64_t rows, int col_blocks,
               int red, const __grid_constant__ EwProgram prog) {
  constexpr int CPB = VEC ? COLS * NV : COLS;  // columns a block
  const int64_t col0 = (int64_t)(blockIdx.x % col_blocks) * CPB;
  const int64_t chunk = blockIdx.x / col_blocks;
  const int64_t r0 = chunk * rows, r1 = r0 + rows < N ? r0 + rows : N;
  __shared__ EwVal part[LANES][COLS * NV];
  if constexpr (VEC) {
    __shared__ uint4 ring[RING_ROWS * 2 * THREADS];
    program_vector<FL, R>(in, M, r0, r1, col0, red, prog, ring, part);
  } else {
    program_column<FL, R>(in, M, r0, r1, col0, red, prog, part);
  }
  finish_block(part, CPB, col0, M, col_blocks, out, scratch, tickets, prog.out_type,
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

using ProgramKernel = decltype(&reduce_program<true, 2, true>);

template <bool FL, int R>
ProgramKernel program_kernel(bool vec) {
  return vec ? reduce_program<FL, R, true> : reduce_program<FL, R, false>;
}

template <bool FL>
ProgramKernel pick_program(int r, bool vec) {
  switch (r) {
    case 1: return reduce_program<FL, 1, true>;
    case 2: return program_kernel<FL, 2>(vec);
    case 4: return program_kernel<FL, 4>(vec);
    default: return program_kernel<FL, 0>(vec);
  }
}

// The width (columns a thread) and blocks an SM of the kernel the launcher
// runs for a program of n_instr instructions and n_reg registers on rows
// that allow 8 columns a thread (vec_ok: whole 16-byte runs on an aligned
// base) or not. Every program takes 8 columns a thread where the rows allow.
void launch_shape(int n_instr, int n_reg, bool vec_ok, int* vec, int* per_sm) {
  *vec = vec_ok ? NV : 1;
  *per_sm = n_instr == 0 ? IDENTITY_BLOCKS : program_blocks(register_file(n_reg, vec_ok), vec_ok);
}

}  // namespace

// What core/stream_reduce.py::split cuts a launch by: launch_shape.
extern "C" void strided_stream_reduce_shape(int n_instr, int n_reg, int vec_ok, int* vec,
                                            int* per_sm) {
  launch_shape(n_instr, n_reg, vec_ok != 0, vec, per_sm);
}

// What *path reports (core/stream_reduce.py: path_name): the kernel
// launched, with SR_VECTOR set when a thread owned NV columns.
enum { SR_IDENTITY = 0, SR_AMORTIZED = 1, SR_SCALAR = 2, SR_VECTOR = 4 };

// in: (N, M) dense, of the program's leaf type; out: (M,) of its result
// type. When chunks > 1: scratch holds chunks * M 4-byte values, and
// tickets n_tickets >= the column blocks, 0 at the launch and 0 again after
// it (one buffer per stream: launches on a stream run one after another).
// The split (chunks of ``rows`` rows, vec: 8 columns a thread) comes from
// core/stream_reduce.py, after strided_stream_reduce_shape; vec = NV needs
// rows of whole 16-byte runs on a 16-byte aligned base, and a program that
// takes 8 columns a thread. *path is set to what ran: SR_IDENTITY
// (reduce_identity), SR_AMORTIZED (reduce_program on the amortized
// interpreter) or SR_SCALAR (on the scalar one), | SR_VECTOR for vec = NV.
extern "C" int strided_stream_reduce(const void* in, void* out, void* scratch, void* tickets,
                                     int n_tickets, int64_t N, int64_t M, int chunks, int64_t rows,
                                     int vec, int red, const EwProgram* prog, void* stream,
                                     int* path) {
  const int lt = prog->in_type[0];
  const bool identity = prog->n_instr == 0;
  const int64_t align = lt == EW_BF16 ? 8 : 4;  // elements in 16 bytes
  int vec_ok, per_sm;
  launch_shape(prog->n_instr, prog->n_reg, true, &vec_ok, &per_sm);
  if (N < 1 || M < 1 || chunks < 1 || rows < 1 || rows % STEP != 0 ||
      (int64_t)chunks * rows < N || (int64_t)(chunks - 1) * rows >= N ||
      (vec != 1 && vec != NV) || red < EW_RED_SUM || red > EW_RED_MAX ||
      prog->n_reg < 1 || prog->n_reg > EW_MAX_REG ||
      (vec == NV && (vec_ok != NV || M % align != 0 || ((uintptr_t)in & 15))))
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
    *path = SR_IDENTITY;
  } else {
    const int r = register_file(prog->n_reg, vec == NV);
    ProgramKernel k = ew_is_float(prog->out_type) ? pick_program<true>(r, vec == NV)
                                                  : pick_program<false>(r, vec == NV);
    k<<<grid, block, 0, s>>>(in, out, sc, tk, N, M, rows, (int)col_blocks, red, *prog);
    *path = r == 0 ? SR_SCALAR : SR_AMORTIZED;
  }
  if (vec == NV) *path |= SR_VECTOR;
  return (int)cudaGetLastError();
}
