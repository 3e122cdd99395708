// K4: the generic tile executor, the engine's map / map-reduce kernel.
//
// Replaces the Pallas kernel strided_tpu/core/executor_pallas.py::_run: over
// an iteration space of up to 5 fused and ordered dims (core/planner.py),
// out[I] = f(in_0[I], ..., in_k[I]) for a map, or
// out[I] = op(initop(old[I]), fold over the reduced dims of f(in[I, R]))
// for a map-reduce. Every operand is a pure reshape of its flat parent and
// has its own strides (0 on broadcast dims; the output's are 0 on reduced
// dims) and offset. f and initop arrive as elementwise programs
// (ewise.cuh).
//
// What bounds it on an H100: bytes, each operand element read once and each
// output element written once, against 3.35 TB/s. Its layouts are the
// scrambled ones (transposed reads), where one side of the copy cannot be
// coalesced.
//
// Design of a map. One whose inputs read transposed goes through 32 x 64
// tiles in padded shared memory, the Hopper form of the TPU kernel's
// in-VMEM transpose: every load and store is coalesced. The other maps have
// the output's unit-stride dim innermost in the loop order, so a thread's
// consecutive elements are 256 apart and every access is coalesced.
// Interpreting f per element costs more than the memory (on an H100 the
// 8192^2 smap ran at 1042 GB/s that way: a 40-entry register array in local
// memory, behind a switch, for every operand of every instruction; PERF.md).
// A copy's tile kernel (tile_copy_t2d) is separate. So a map whose compacted
// body (core/ewise.py::compact) needs at most EW_CREG registers, and has at
// most EW_CREG inputs, runs in three phases: every thread first issues all
// its loads (8 elements a thread, constant trip counts: staged inputs into
// the tile, the others into registers), then runs the program once over its
// 8 elements (ewise.cuh::ew_run_v, the register file in registers), then
// stores (tile_t2d_v, tile_map_v). A wider program runs the scalar
// interpreter per element (tile_executor_t2d, and the map branch of
// tile_executor_kernel).
// tile_t2d_v stages only the inputs that are unit-stride along its one
// tiled dim; every other input is read along dx with gaps between the
// threads. Where the inputs are unit-stride along two or three distinct
// dims other than dx (the README's A + permutedims(A,P2) + permutedims(A,P3)
// + permutedims(A,P4): A along dx, the views along k, j and i), the
// multi-axis form (tile_box_v) takes the map instead: a block owns a box of
// 8 along dx and 8 along each staging dim (64 along dx for two), each
// staged input is read along its own staging dim, 8 elements (a 32-byte
// sector of f32) a run, into a slab of shared memory of its own (XOR
// swizzled, no bank conflict either way; 32-bit words by cp.async), and
// every thread reads its elements back in the output's order and runs the
// program as tile_t2d_v does, in passes of 4. What bounds it: a run is a
// sector, not a line, so 4 boxes along every box axis are consecutive
// blocks (a line's four sectors are read while it is in L2), and the count
// of 32-byte runs sets the time (bf16, half the bytes in the same runs,
// takes as long as f32; PERF.md). Its budget is 64 registers and 48 KB of
// slabs for three staged inputs at four blocks an SM; four staging dims
// (a box of 8^5) do not fit, and stay on tile_t2d_v. The planner
// (core/executor_cuda.py::_staging) chooses it from the strides alone.
// A map whose operands are all unit-stride along its one loop dim
// (core/executor_cuda.py plans a call whose operands share one dense layout
// as a single dim of n elements) streams (tile_stream_v): each thread owns 8 consecutive
// elements, loads them 16 bytes at a time (two loads of f32 or int32, one of
// bf16), runs the program over them and stores them 16 bytes at a time; no
// address arithmetic but one add. Its interpreter is the select one
// (ewise.cuh::ew_run_s): past two or three instructions the interpreter, not
// the bytes, sets the time, and on the README broadcast the select form took
// 0.31 ms at 8192^2 f32 where the copying one (ew_run_v) took 0.41 and
// tile_map_v's addressing 0.76 (PERF.md). It alone runs programs holding exp
// or sin (ewise.cuh: its TR instances).
// For a reduction a block owns 32 output elements (1 below 32 outputs) and
// splits the reduced extent over the rest of its 256 threads; where that
// leaves the SMs idle the extent is also cut into chunks over blocks. Each
// thread folds its share in order, a fixed-order merge in shared memory
// combines a block's, a second pass merges the chunks' partials in chunk
// order, and one thread applies initop to the old value exactly once,
// folds the result in and writes once. This loop inside the
// block replaces the TPU's sequential reduction grid axes, which cannot
// carry over because blocks run in no order. No atomics: deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ewise.cuh"

#define TE_MAX_DIM 5
#define TE_MAX_IN EW_MAX_IN

// Exported through the C launcher, so these live outside the anonymous
// namespace (core/executor_cuda.py mirrors them with ctypes).
struct TeOperand {
  const void* ptr;
  int64_t stride[TE_MAX_DIM];
  int64_t offset;
  int32_t type, pad;
};

struct TeParams {
  int32_t rank, n_par, n_in, red;  // red < 0: a map
  int64_t dims[TE_MAX_DIM];
  int64_t n_out, n_red;
  int32_t part_type;
  int32_t tdim;    // a map's tiled dim (>= 0: stage the inputs in tmask through shared memory)
  int32_t tmask;   // bit k: input k reads along tdim with stride 1
  int32_t chunks;  // a reduction's chunks of the reduced extent (> 1: partials in scratch)
  int32_t x_lanes;  // a reduction's outputs per block (1, 8 or 32)
  int32_t compact;  // a map whose body fits EW_CREG registers: the amortized kernels
  int32_t stage[TE_MAX_IN];  // a map's staging dim of input k, or -1 (read directly); all -1: none
  EwVal* scratch;        // chunks * n_out partials
  TeOperand out, old;  // old: the output's previous values (reductions)
  TeOperand in[TE_MAX_IN];
  EwProgram body, init;  // f (result: out type for a map, partial type for a reduction); initop
};

namespace {

constexpr int THREADS = 256;

// Add coordinate c of loop dim d to every operand's offset.
__device__ __forceinline__ void advance(const TeParams& p, int d, int64_t c, int64_t* off) {
  for (int k = 0; k < p.n_in; ++k) off[k] += c * p.in[k].stride[d];
}

// Offset of input 0 at linear reduction index r (the trailing loop dims).
__device__ __forceinline__ int64_t red_offset(const TeParams& p, int64_t r) {
  if (p.rank - p.n_par == 1) return r * p.in[0].stride[p.rank - 1];  // no division
  uint32_t rem = (uint32_t)r;
  int64_t off = 0;
  for (int d = p.rank - 1; d >= p.n_par; --d) {
    const uint32_t dim = (uint32_t)p.dims[d];
    off += (int64_t)(rem % dim) * p.in[0].stride[d];
    rem /= dim;
  }
  return off;
}

__device__ __forceinline__ EwVal eval1(const EwProgram& prog, EwVal x) {
  if (prog.n_instr == 0) return x;
  EwVal r[EW_MAX_REG];
  r[0] = x;
  return ew_run(prog, r);
}

__device__ __forceinline__ EwVal eval_at(const TeParams& p, const int64_t* off) {
  EwVal r[EW_MAX_REG];
  for (int k = 0; k < p.n_in; ++k) r[k] = ew_load(p.in[k].ptr, off[k], p.in[k].type);
  return ew_run(p.body, r);
}

// Output offset of linear output index o (the parallel loop dims).
__device__ __forceinline__ int64_t out_offset(const TeParams& p, int64_t o) {
  uint32_t rem = (uint32_t)o;
  int64_t off = p.out.offset;
  for (int d = p.n_par - 1; d >= 0; --d) {
    const uint32_t dim = (uint32_t)p.dims[d];
    off += (int64_t)(rem % dim) * p.out.stride[d];
    rem /= dim;
  }
  return off;
}

// A reduction's last step for one output: the folded partial in its own
// type, then op(initop(old), partial), written once.
__device__ __forceinline__ void finish(const TeParams& p, int64_t out_off, EwVal acc) {
  const int t = p.part_type;
  const bool truth = p.red == EW_RED_ALL || p.red == EW_RED_ANY;
  if (!truth && t == EW_BF16) acc.f = ew_bf16(acc.f);
  EwVal reg[EW_MAX_REG];
  reg[0] = ew_load(p.old.ptr, out_off, p.old.type);
  EwVal seed = ew_run(p.init, reg);  // initop (or identity), cast to the partial type
  EwVal fin = ew_red_merge(p.red, t, seed, acc);
  if (!truth && t == EW_BF16) fin.f = ew_bf16(fin.f);
  ew_store((void*)p.out.ptr, out_off, p.out.type, ew_cast(fin, truth ? EW_BOOL : t, p.out.type));
}

__global__ void __launch_bounds__(THREADS) tile_executor_kernel(const __grid_constant__ TeParams p) {
  __shared__ EwVal part[THREADS];
  const int X = blockDim.x, Y = blockDim.y;
  const int64_t o = (int64_t)blockIdx.x * X + threadIdx.x;
  const bool live = o < p.n_out;
  int64_t off[TE_MAX_IN];
  int64_t out_off = p.out.offset;
  for (int k = 0; k < p.n_in; ++k) off[k] = p.in[k].offset;
  if (live) {  // coordinates in 32 bits: the wrapper keeps the space below 2^31
    uint32_t rem = (uint32_t)o;
    for (int d = p.n_par - 1; d >= 0; --d) {
      const uint32_t dim = (uint32_t)p.dims[d], c = rem % dim;
      rem /= dim;
      advance(p, d, c, off);
      out_off += (int64_t)c * p.out.stride[d];
    }
  }
  if (p.red < 0) {  // map: the body already yields the output type
    if (live) ew_store((void*)p.out.ptr, out_off, p.out.type, eval_at(p, off));
    return;
  }
  const int t = p.part_type;
  EwVal acc = ew_red_identity(p.red, t);
  const int64_t per = (p.n_red + p.chunks - 1) / p.chunks;  // this block's share
  const int64_t r0 = (int64_t)blockIdx.y * per;
  const int64_t r1 = r0 + per < p.n_red ? r0 + per : p.n_red;
  if (live && p.n_in == 1) {  // one input: eight loads in flight, then eight folds
    constexpr int U = 8;
    int64_t r = r0 + threadIdx.y;
    for (; r + (U - 1) * Y < r1; r += U * Y) {
      EwVal x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = ew_load(p.in[0].ptr, off[0] + red_offset(p, r + u * Y), p.in[0].type);
#pragma unroll
      for (int u = 0; u < U; ++u) acc = ew_red_fold(p.red, t, acc, eval1(p.body, x[u]));
    }
    for (; r < r1; r += Y)
      acc = ew_red_fold(p.red, t, acc,
                        eval1(p.body, ew_load(p.in[0].ptr, off[0] + red_offset(p, r), p.in[0].type)));
  } else if (live) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += Y) {
      int64_t roff[TE_MAX_IN];
      for (int k = 0; k < p.n_in; ++k) roff[k] = off[k];
      uint32_t rem = (uint32_t)r;
      for (int d = p.rank - 1; d >= p.n_par; --d) {
        const uint32_t dim = (uint32_t)p.dims[d];
        advance(p, d, rem % dim, roff);
        rem /= dim;
      }
      acc = ew_red_fold(p.red, t, acc, eval_at(p, roff));
    }
  }
  part[threadIdx.y * X + threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || !live) return;
  for (int l = 1; l < Y; ++l) acc = ew_red_merge(p.red, t, acc, part[l * X + threadIdx.x]);
  if (gridDim.y > 1)
    p.scratch[(int64_t)blockIdx.y * p.n_out + o] = acc;
  else
    finish(p, out_off, acc);
}

// Second pass of a chunked reduction: the chunks' partials merged in chunk
// order, then finish (initop once, one write).
__global__ void tile_executor_merge(const __grid_constant__ TeParams p) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= p.n_out) return;
  EwVal acc = p.scratch[o];
  for (int c = 1; c < p.chunks; ++c)
    acc = ew_red_merge(p.red, p.part_type, acc, p.scratch[(int64_t)c * p.n_out + o]);
  finish(p, out_offset(p, o), acc);
}

// A map whose inputs read transposed: tiles of 32 (along the last loop dim,
// the output's unit-stride dim) x 64 (along tdim). The inputs in tmask are
// read along tdim (their unit-stride dim) with coalesced loads into padded
// shared memory (one slot per staged input, dynamic), then every thread
// computes output elements along the last dim and writes them coalesced; a
// thread keeps eight loads and eight stores in flight. The other loop dims
// index the tile rows.
constexpr int TX = 32, TY = 64, R2 = 8;
constexpr int SLOT = TX * (TY + 1);  // EwVals per staged input

__global__ void __launch_bounds__(TX * R2) tile_executor_t2d(const __grid_constant__ TeParams p) {
  extern __shared__ EwVal tiles[];
  const int dx = p.rank - 1, dy = p.tdim;
  const uint32_t nx = (uint32_t)p.dims[dx], ny = (uint32_t)p.dims[dy];
  const uint32_t tx_tiles = (nx + TX - 1) / TX, ty_tiles = (ny + TY - 1) / TY;
  uint32_t b = blockIdx.x;
  const uint32_t x0 = (b % tx_tiles) * TX;
  b /= tx_tiles;
  const uint32_t y0 = (b % ty_tiles) * TY;
  b /= ty_tiles;
  int64_t off[TE_MAX_IN];
  int64_t out_off = p.out.offset;
  for (int k = 0; k < p.n_in; ++k) off[k] = p.in[k].offset;
  for (int d = dx - 1; d >= 0; --d) {  // the tile row: every other dim
    if (d == dy) continue;
    const uint32_t dim = (uint32_t)p.dims[d], c = b % dim;
    b /= dim;
    advance(p, d, c, off);
    out_off += (int64_t)c * p.out.stride[d];
  }
  const int tx = threadIdx.x, ty = threadIdx.y;
  int slot = 0;
  for (int k = 0; k < p.n_in; ++k) {
    if (!((p.tmask >> k) & 1)) continue;
    EwVal* tile = tiles + slot++ * SLOT;  // tile[x][y], row length TY + 1
#pragma unroll
    for (int c = 0; c < TY; c += TX) {
      const uint32_t y = y0 + c + tx;
#pragma unroll
      for (int j = ty; j < TX; j += R2) {
        const uint32_t x = x0 + j;
        if (x < nx && y < ny)
          tile[j * (TY + 1) + c + tx] = ew_load(
              p.in[k].ptr, off[k] + (int64_t)y * p.in[k].stride[dy] + (int64_t)x * p.in[k].stride[dx],
              p.in[k].type);
      }
    }
  }
  __syncthreads();
  const uint32_t x = x0 + tx;
  if (x >= nx) return;
  for (int i = ty; i < TY; i += R2) {
    const uint32_t y = y0 + i;
    if (y >= ny) break;
    EwVal r[EW_MAX_REG];
    int s = 0;
    for (int k = 0; k < p.n_in; ++k)
      r[k] = ((p.tmask >> k) & 1)
                 ? tiles[s++ * SLOT + tx * (TY + 1) + i]
                 : ew_load(p.in[k].ptr, off[k] + (int64_t)y * p.in[k].stride[dy] +
                                            (int64_t)x * p.in[k].stride[dx], p.in[k].type);
    const EwVal v = ew_run(p.body, r);
    ew_store((void*)p.out.ptr,
             out_off + (int64_t)y * p.out.stride[dy] + (int64_t)x * p.out.stride[dx],
             p.out.type, v);
  }
}

// The amortized forms. Eight elements a thread: output element o + 256e of
// the block's 2048 (tile_map_v), or row ty + 8e of a 32 x 64 tile
// (tile_t2d_v). Inputs k < n_in <= R are loaded straight into register k of
// the program's R x 8 register file, R = 2, 3 or 4, the fewest that hold the
// body (the cost of reading and writing a register grows with R). Offsets
// are 32-bit: every operand is a reshape of a parent of fewer than 2^31
// elements (core/executor_cuda.py).
constexpr int PER = 8;  // elements a thread

template <int R>
__global__ void __launch_bounds__(THREADS, 2) tile_map_v(const __grid_constant__ TeParams p) {
  EwVal r[R][PER];
  int32_t off[R][PER], out_off[PER];
  bool ok[PER];
  const int64_t base = (int64_t)blockIdx.x * THREADS * PER + threadIdx.x;
#pragma unroll
  for (int e = 0; e < PER; ++e) {  // every address first
    const int64_t o = base + e * THREADS;
    ok[e] = o < p.n_out;
    uint32_t rem = ok[e] ? (uint32_t)o : 0u;
    out_off[e] = (int32_t)p.out.offset;
#pragma unroll
    for (int k = 0; k < R; ++k) off[k][e] = (int32_t)p.in[k].offset;
    for (int d = p.rank - 1; d >= 0; --d) {
      const uint32_t dim = (uint32_t)p.dims[d], c = rem % dim;
      rem /= dim;
#pragma unroll
      for (int k = 0; k < R; ++k) off[k][e] += (int32_t)c * (int32_t)p.in[k].stride[d];
      out_off[e] += (int32_t)c * (int32_t)p.out.stride[d];
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)  // then every load
    if (k < p.n_in) ew_load_v<PER>(p.in[k].ptr, off[k], ok, p.in[k].type, r[k]);
  ew_run_v(p.body, r);
  EwVal v[PER];
  ew_reg(r, p.body.out, v);
  ew_store_v<PER>((void*)p.out.ptr, out_off, ok, p.out.type, v);
}

template <int R>  // R = 2 fits 80 registers, so three blocks an SM; 3 and 4 would spill there
__global__ void __launch_bounds__(TX * R2, R == 2 ? 3 : 2) tile_t2d_v(const __grid_constant__ TeParams p) {
  extern __shared__ EwVal tiles[];
  const int dx = p.rank - 1, dy = p.tdim;
  const uint32_t nx = (uint32_t)p.dims[dx], ny = (uint32_t)p.dims[dy];
  const uint32_t tx_tiles = (nx + TX - 1) / TX, ty_tiles = (ny + TY - 1) / TY;
  uint32_t b = blockIdx.x;
  const uint32_t x0 = (b % tx_tiles) * TX;
  b /= tx_tiles;
  const uint32_t y0 = (b % ty_tiles) * TY;
  b /= ty_tiles;
  int32_t off[R];
  int32_t out_off = (int32_t)p.out.offset;
#pragma unroll
  for (int k = 0; k < R; ++k) off[k] = (int32_t)p.in[k].offset;
  for (int d = dx - 1; d >= 0; --d) {  // the tile row: every other dim
    if (d == dy) continue;
    const uint32_t dim = (uint32_t)p.dims[d], c = b % dim;
    b /= dim;
#pragma unroll
    for (int k = 0; k < R; ++k) off[k] += (int32_t)c * (int32_t)p.in[k].stride[d];
    out_off += (int32_t)c * (int32_t)p.out.stride[d];
  }
  const int tx = threadIdx.x, ty = threadIdx.y;
  const uint32_t x = x0 + tx;
  // the thread's elements: rows y0 + ty + 8e of column x
  bool ok[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) ok[e] = x < nx && y0 + ty + e * R2 < ny;
  EwVal r[R][PER];
  // phase 1: every load. A staged input is read along tdim, its unit-stride
  // dim, into tile[x][y] (element q of the thread: tile column ty +
  // 8(q % 4), row 32(q / 4) + tx); the others straight into registers.
  int slot = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k >= p.n_in) continue;
    const TeOperand& o = p.in[k];
    const int32_t sx = (int32_t)o.stride[dx], sy = (int32_t)o.stride[dy];
    int32_t idx[PER];
    if ((p.tmask >> k) & 1) {
      bool in[PER];
      EwVal t[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const uint32_t xx = x0 + ty + (q % 4) * R2, yy = y0 + (q / 4) * TX + tx;
        in[q] = xx < nx && yy < ny;
        idx[q] = off[k] + (int32_t)yy * sy + (int32_t)xx * sx;
      }
      ew_load_v<PER>(o.ptr, idx, in, o.type, t);
      EwVal* tile = tiles + slot++ * SLOT;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (in[q]) tile[(ty + (q % 4) * R2) * (TY + 1) + (q / 4) * TX + tx] = t[q];
    } else {
      const int32_t at = off[k] + (int32_t)(y0 + ty) * sy + (int32_t)x * sx;
#pragma unroll
      for (int e = 0; e < PER; ++e) idx[e] = at + e * R2 * sy;
      ew_load_v<PER>(o.ptr, idx, ok, o.type, r[k]);
    }
  }
  __syncthreads();
  slot = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k >= p.n_in || !((p.tmask >> k) & 1)) continue;
    const EwVal* tile = tiles + slot++ * SLOT + tx * (TY + 1) + ty;
#pragma unroll
    for (int e = 0; e < PER; ++e) r[k][e] = tile[e * R2];
  }
  // phase 2: the program over the thread's 8 elements; phase 3: the stores
  ew_run_v(p.body, r);
  EwVal v[PER];
  ew_reg(r, p.body.out, v);
  const int32_t oy = (int32_t)p.out.stride[dy];
  const int32_t at = out_off + (int32_t)(y0 + ty) * oy + (int32_t)x * (int32_t)p.out.stride[dx];
  int32_t idx[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) idx[e] = at + e * R2 * oy;
  ew_store_v<PER>((void*)p.out.ptr, idx, ok, p.out.type, v);
}

typedef void (*TeKernel)(TeParams);

// Eight elements of memory type t at base[i .. i + 8), a 16-byte aligned
// run: one 16-byte load of bf16 (widened to f32 by a shift), two of f32 or
// int32 (moved as 32-bit words, as ew_load_v does).
__device__ __forceinline__ void load8(const void* base, int64_t i, int t, EwVal* v) {
  if (t == EW_BF16) {
    const uint4 q = __ldg((const uint4*)((const __nv_bfloat16*)base + i));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j].i = (int32_t)(w[j] << 16);
      v[2 * j + 1].i = (int32_t)(w[j] & 0xffff0000u);
    }
  } else {
    const uint4* q = (const uint4*)((const int32_t*)base + i);
    const uint4 a = __ldg(q), b = __ldg(q + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e].i = (int32_t)w[e];
  }
}

__device__ __forceinline__ void store8(void* base, int64_t i, int t, const EwVal* v) {
  if (t == EW_BF16) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j].f)) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1].f)) << 16);
    *(uint4*)((__nv_bfloat16*)base + i) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    uint4* q = (uint4*)((int32_t*)base + i);
    q[0] = make_uint4((uint32_t)v[0].i, (uint32_t)v[1].i, (uint32_t)v[2].i, (uint32_t)v[3].i);
    q[1] = make_uint4((uint32_t)v[4].i, (uint32_t)v[5].i, (uint32_t)v[6].i, (uint32_t)v[7].i);
  }
}

// The streaming form (rank 1, every operand unit-stride). A thread's 8
// elements are whole and 16-byte aligned where ``vec`` (every operand's
// first element on a 16-byte boundary) and the run ends inside n; the
// ragged tail, and every run of an operand set that is not aligned, take
// the same 8 elements with 4- or 2-byte accesses (scalar edges). The
// program runs on the select interpreter over the R x 8 register file. TR:
// the program may hold exp and sin.
template <int R, bool TR>
__global__ void __launch_bounds__(THREADS) tile_stream_v(const __grid_constant__ TeParams p,
                                                         const bool vec) {
  const int64_t n = p.n_out, i0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * PER;
  if (i0 >= n) return;
  const bool whole = vec && i0 + PER <= n;
  int64_t idx[PER];
  bool ok[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    idx[e] = i0 + e;
    ok[e] = i0 + e < n;
  }
  EwVal r[R][PER];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k >= p.n_in) continue;
    const TeOperand& o = p.in[k];
    const void* base = (const char*)o.ptr + o.offset * (o.type == EW_BF16 ? 2 : 4);
    if (whole) load8(base, i0, o.type, r[k]);
    else ew_load_v<PER>(base, idx, ok, o.type, r[k]);
  }
  ew_run_s<R, PER, TR>(p.body, r);
  EwVal v[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) v[e] = ew_sel(r, p.body.out, e);
  void* out = (char*)p.out.ptr + p.out.offset * (p.out.type == EW_BF16 ? 2 : 4);
  if (whole) store8(out, i0, p.out.type, v);
  else ew_store_v<PER>(out, idx, ok, p.out.type, v);
}

// Launch the streaming form: one 8-element run a thread, the register file
// of the fewest registers that hold the body, the TR instances for a body
// holding exp or sin.
int launch_stream(const TeParams* p, cudaStream_t s) {
  const int64_t blocks = (p->n_out + THREADS * PER - 1) / (THREADS * PER);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bool vec = true;
  for (int k = -1; k < p->n_in; ++k) {
    const TeOperand& o = k < 0 ? p->out : p->in[k];
    const uintptr_t at = (uintptr_t)o.ptr + (uintptr_t)(o.offset * (o.type == EW_BF16 ? 2 : 4));
    vec = vec && (at & 15) == 0;
  }
  const int regs = p->body.n_reg;
  typedef void (*StreamKernel)(TeParams, bool);
  StreamKernel k;
  if (ew_transcendental(p->body))
    k = regs <= 2 ? tile_stream_v<2, true> : regs == 3 ? tile_stream_v<3, true> : tile_stream_v<4, true>;
  else
    k = regs <= 2 ? tile_stream_v<2, false> : regs == 3 ? tile_stream_v<3, false> : tile_stream_v<4, false>;
  k<<<(unsigned)blocks, THREADS, 0, s>>>(*p, vec);
  return (int)cudaGetLastError();
}

// Whether the map streams: rank 1, every operand unit-stride, a body and
// inputs within EW_CREG registers (compact).
bool streams(const TeParams* p) {
  if (p->red >= 0 || p->tdim >= 0 || p->rank != 1 || !p->compact || p->out.stride[0] != 1)
    return false;
  for (int k = 0; k < p->n_in; ++k)
    if (p->in[k].stride[0] != 1) return false;
  return true;
}

// The same tiles for the commonest case, a transposed copy (one input, the
// identity, one type): T is the element type, and nothing but the copy is
// left in the loop.
template <typename T>
__global__ void __launch_bounds__(TX * R2) tile_copy_t2d(const __grid_constant__ TeParams p) {
  __shared__ T tile[TX][TY + 1];
  const int dx = p.rank - 1, dy = p.tdim;
  const uint32_t nx = (uint32_t)p.dims[dx], ny = (uint32_t)p.dims[dy];
  const uint32_t tx_tiles = (nx + TX - 1) / TX, ty_tiles = (ny + TY - 1) / TY;
  uint32_t b = blockIdx.x;
  const uint32_t x0 = (b % tx_tiles) * TX;
  b /= tx_tiles;
  const uint32_t y0 = (b % ty_tiles) * TY;
  b /= ty_tiles;
  int64_t in_off = p.in[0].offset, out_off = p.out.offset;
  for (int d = dx - 1; d >= 0; --d) {
    if (d == dy) continue;
    const uint32_t dim = (uint32_t)p.dims[d], c = b % dim;
    b /= dim;
    in_off += (int64_t)c * p.in[0].stride[d];
    out_off += (int64_t)c * p.out.stride[d];
  }
  const T* __restrict__ src = (const T*)p.in[0].ptr + in_off;
  T* __restrict__ dst = (T*)p.out.ptr + out_off;
  const int64_t sx = p.in[0].stride[dx], sy = p.in[0].stride[dy];
  const int64_t ox = p.out.stride[dx], oy = p.out.stride[dy];
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int c = 0; c < TY; c += TX) {
    const uint32_t y = y0 + c + tx;
#pragma unroll
    for (int j = ty; j < TX; j += R2) {
      const uint32_t x = x0 + j;
      if (x < nx && y < ny) tile[j][c + tx] = src[(int64_t)y * sy + (int64_t)x * sx];
    }
  }
  __syncthreads();
  const uint32_t x = x0 + tx;
  if (x >= nx) return;
#pragma unroll
  for (int i = ty; i < TY; i += R2) {
    const uint32_t y = y0 + i;
    if (y < ny) dst[(int64_t)y * oy + (int64_t)x * ox] = tile[tx][i];
  }
}

// The multi-axis form (tile_box_v). A block owns a box of 2^LX elements
// along dx, the output's unit-stride dim (box axis 0), and BE along each of
// the NU staging dims (axes 1..NU, ascending loop dims); the other dims
// index the boxes. An element of the box is numbered in the natural order
// (axis 0 fastest, then 1, 2, ...); a thread owns elements t + 256 q.
constexpr int LBE = 3, BE = 1 << LBE;  // 8 along a staging dim: 32 bytes of f32, one sector
constexpr int BOX_BLOCKS = 4;  // blocks an SM: 64 registers, 48 KB of slabs for three inputs
constexpr int LGROUP = 2;      // 4 boxes along every box axis are consecutive blocks
constexpr int BOX_PASS = 4;    // elements a thread in each pass of the program

template <int NU, int LX>
struct Box {
  static constexpr int NA = NU + 1;               // box axes
  static constexpr int LB = LX + LBE * NU;        // log2 of the box's elements
  static constexpr int PT = (1 << LB) / THREADS;  // elements a thread
  __host__ __device__ static constexpr int width(int a) { return a == 0 ? LX : LBE; }
  __host__ __device__ static constexpr int shift(int a) { return a == 0 ? 0 : LX + LBE * (a - 1); }
};

// The coordinates of element m of the order in which axis F comes first and
// the others follow ascending (F = 0: the natural order).
template <int NU, int LX, int F>
__device__ __forceinline__ void box_coords(uint32_t m, uint32_t (&c)[NU + 1]) {
  using B = Box<NU, LX>;
  c[F] = m & ((1u << B::width(F)) - 1);
  m >>= B::width(F);
#pragma unroll
  for (int a = 0; a <= NU; ++a) {
    if (a == F) continue;
    c[a] = m & ((1u << B::width(a)) - 1);
    m >>= B::width(a);
  }
}

// The slab word of the element at c: its natural number with bits 2-4
// XORed by the XOR of its staging coordinates. So a warp's 32 stores (8
// along one staging axis x 4 along dx) and its 32 loads (natural order)
// each meet 32 banks. Linear in XOR: the word of c | c' (disjoint bits) is
// the XOR of the two words, so a thread's words are its own XOR constants.
template <int NU, int LX>
__device__ __forceinline__ uint32_t slab_word(const uint32_t (&c)[NU + 1]) {
  using B = Box<NU, LX>;
  uint32_t n = 0, v = 0;
#pragma unroll
  for (int a = 0; a <= NU; ++a) {
    n |= c[a] << B::shift(a);
    if (a > 0) v ^= c[a];
  }
  return n ^ ((v & 7u) << 2);
}

// Phase 1 for one staged input: its box read along its own staging axis F
// (8 consecutive elements, a sector of f32, per run; a warp reads 4 runs)
// into its slab. 32-bit words go by cp.async, straight into the slab with
// no register and every load in flight; bf16 values through registers, as
// EwVals. base: the input's offset at the box's origin; lim: the box's
// extent along each axis, clipped at the array's edge.
template <int NU, int LX, int F>
__device__ __forceinline__ void stage_box(const TeOperand& o, const int (&ad)[NU + 1],
                                          int32_t base, const uint32_t (&lim)[NU + 1],
                                          bool full, EwVal* slab) {
  using B = Box<NU, LX>;
  constexpr int PT = B::PT;
  uint32_t ct[NU + 1];
  box_coords<NU, LX, F>(threadIdx.x, ct);
  int32_t s[NU + 1], at = base;
#pragma unroll
  for (int a = 0; a <= NU; ++a) {
    s[a] = (int32_t)o.stride[ad[a]];
    at += (int32_t)ct[a] * s[a];
  }
  const uint32_t wt = slab_word<NU, LX>(ct);
  int32_t idx[PT];
  uint32_t word[PT];
  bool ok[PT];
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    uint32_t cq[NU + 1];
    box_coords<NU, LX, F>((uint32_t)q * THREADS, cq);
    bool in = true;
    idx[q] = at;
#pragma unroll
    for (int a = 0; a <= NU; ++a) {
      idx[q] += (int32_t)cq[a] * s[a];
      in = in && (ct[a] | cq[a]) < lim[a];
    }
    ok[q] = full || in;
    word[q] = wt ^ slab_word<NU, LX>(cq);
  }
  if (o.type != EW_BF16) {
    const uint32_t at_slab = (uint32_t)__cvta_generic_to_shared(slab);
#pragma unroll
    for (int q = 0; q < PT; ++q)
      if (ok[q])
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at_slab + 4 * word[q]),
                     "l"((const int32_t*)o.ptr + idx[q]) : "memory");
    return;
  }
  EwVal v[PT];
  ew_load_v<PT>(o.ptr, idx, ok, o.type, v);
#pragma unroll
  for (int q = 0; q < PT; ++q)
    if (ok[q]) slab[word[q]] = v[q];
}

// A map whose inputs are unit-stride along NU = 2 or 3 distinct loop dims
// other than dx (p.stage). Phase 1: every staged input into its own slab
// (stage_box), the box's 2^LB EwVals each. Phase 2, in passes of BOX_PASS
// elements a thread (natural order, so a warp's 32 elements are 4 runs of
// 8 along dx for LX = 3): the staged values from the slabs, the direct
// inputs (unit-stride along dx, broadcast or with no unit-stride dim) from
// memory, the program (ew_run_v), the stores. Offsets are 32-bit, as in
// the other amortized kernels. The register file is EW_CREG wide whatever
// the body's n_reg (the same program runs on any file that holds it), so
// there is one instance a box shape.
template <int NU, int LX>
__global__ void __launch_bounds__(THREADS, BOX_BLOCKS) tile_box_v(const __grid_constant__ TeParams p) {
  using B = Box<NU, LX>;
  constexpr int NA = B::NA, PT = B::PT, EP = BOX_PASS, R = EW_CREG;
  extern __shared__ EwVal slabs[];
  const int dx = p.rank - 1;
  uint32_t umask = 0;
  for (int k = 0; k < p.n_in; ++k)
    if (p.stage[k] >= 0) umask |= 1u << p.stage[k];
  int ad[NA];  // the loop dim of each box axis
  ad[0] = dx;
  uint32_t m = umask;
#pragma unroll
  for (int a = 1; a < NA; ++a) {
    ad[a] = __ffs(m) - 1;
    m &= m - 1;
  }
  // the box: its place in its group (axis 0 fastest, then the staging axes
  // from the innermost loop dim out), then the group's, then every other
  // dim inner to outer. A group's 2^LGROUP boxes along each axis share the
  // 128-byte lines of every operand, so the lines are whole while in L2.
  uint32_t b = blockIdx.x >> (LGROUP * NA), lim[NA];
  const uint32_t in_group = blockIdx.x & ((1u << (LGROUP * NA)) - 1);
  bool full = true;
  int32_t off[R], out_off = (int32_t)p.out.offset;
#pragma unroll
  for (int k = 0; k < R; ++k) off[k] = (int32_t)p.in[k].offset;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int a = j == 0 ? 0 : NA - j;
    const uint32_t n = (uint32_t)p.dims[ad[a]], nb = (n + (1u << B::width(a)) - 1) >> B::width(a);
    const uint32_t ng = (nb + (1u << LGROUP) - 1) >> LGROUP;
    const uint32_t box = ((b % ng) << LGROUP) | ((in_group >> (LGROUP * j)) & ((1u << LGROUP) - 1));
    b /= ng;
    if (box >= nb) return;  // past the edge: the last group along this axis is short
    const uint32_t c = box << B::width(a);
    lim[a] = min(1u << B::width(a), n - c);
    full = full && lim[a] == 1u << B::width(a);
#pragma unroll
    for (int k = 0; k < R; ++k) off[k] += (int32_t)c * (int32_t)p.in[k].stride[ad[a]];
    out_off += (int32_t)c * (int32_t)p.out.stride[ad[a]];
  }
  for (int d = dx - 1; d >= 0; --d) {
    if ((umask >> d) & 1) continue;
    const uint32_t dim = (uint32_t)p.dims[d], c = b % dim;
    b /= dim;
#pragma unroll
    for (int k = 0; k < R; ++k) off[k] += (int32_t)c * (int32_t)p.in[k].stride[d];
    out_off += (int32_t)c * (int32_t)p.out.stride[d];
  }
  uint32_t ct[NA];  // the thread's coordinates and slab word in the natural order
  box_coords<NU, LX, 0>(threadIdx.x, ct);
  const uint32_t wt = slab_word<NU, LX>(ct);
  // phase 1
  int slot = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k >= p.n_in || p.stage[k] < 0) continue;
    EwVal* slab = slabs + (slot++ << B::LB);
    int f = 1;  // the box axis of input k's staging dim
#pragma unroll
    for (int a = 2; a < NA; ++a)
      if (ad[a] == p.stage[k]) f = a;
    if (f == 1) {
      stage_box<NU, LX, 1>(p.in[k], ad, off[k], lim, full, slab);
    } else if (f == 2) {
      stage_box<NU, LX, 2>(p.in[k], ad, off[k], lim, full, slab);
    } else {
      if constexpr (NU >= 3) stage_box<NU, LX, 3>(p.in[k], ad, off[k], lim, full, slab);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // phase 2: the thread's parts of every offset, then PT / EP passes
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int k = 0; k < R; ++k) off[k] += (int32_t)ct[a] * (int32_t)p.in[k].stride[ad[a]];
    out_off += (int32_t)ct[a] * (int32_t)p.out.stride[ad[a]];
  }
#pragma unroll
  for (int pass = 0; pass < PT / EP; ++pass) {
    uint32_t cq[EP][NA];
    bool ok[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      box_coords<NU, LX, 0>((uint32_t)(pass * EP + e) * THREADS, cq[e]);
      bool in = true;
#pragma unroll
      for (int a = 0; a < NA; ++a) in = in && (ct[a] | cq[e][a]) < lim[a];
      ok[e] = full || in;
    }
    EwVal r[R][EP];
    int32_t idx[EP];
    slot = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k >= p.n_in) continue;
      if (p.stage[k] >= 0) {
        const EwVal* slab = slabs + (slot++ << B::LB);
#pragma unroll
        for (int e = 0; e < EP; ++e)
          if (ok[e]) r[k][e] = slab[wt ^ slab_word<NU, LX>(cq[e])];
      } else {
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          idx[e] = off[k];
#pragma unroll
          for (int a = 0; a < NA; ++a) idx[e] += (int32_t)cq[e][a] * (int32_t)p.in[k].stride[ad[a]];
        }
        ew_load_v<EP>(p.in[k].ptr, idx, ok, p.in[k].type, r[k]);
      }
    }
    ew_run_v(p.body, r);
    EwVal v[EP];
    ew_reg(r, p.body.out, v);
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      idx[e] = out_off;
#pragma unroll
      for (int a = 0; a < NA; ++a) idx[e] += (int32_t)cq[e][a] * (int32_t)p.out.stride[ad[a]];
    }
    ew_store_v<EP>((void*)p.out.ptr, idx, ok, p.out.type, v);
  }
}

// Launch tile_box_v for the staging dims in umask (NU of them) with
// n_staged slabs, in whole groups along every box axis.
template <int NU, int LX>
int launch_box(const TeParams* p, uint32_t umask, int n_staged, cudaStream_t s) {
  using B = Box<NU, LX>;
  static bool raised = false;  // once per instance and process
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(tile_box_v<NU, LX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (EW_CREG << B::LB) * (int)sizeof(EwVal));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tile_box_v<NU, LX>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const int dx = p->rank - 1;
  const int64_t g = (1 << LGROUP) - 1;
  int64_t blocks = ((((p->dims[dx] + (1 << LX) - 1) >> LX) + g) >> LGROUP) << LGROUP;
  for (int d = 0; d < dx; ++d)
    blocks *= (umask >> d) & 1 ? ((((p->dims[d] + BE - 1) / BE) + g) >> LGROUP) << LGROUP : p->dims[d];
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)n_staged << B::LB) * sizeof(EwVal);
  tile_box_v<NU, LX><<<(unsigned)blocks, THREADS, smem, s>>>(*p);
  return (int)cudaGetLastError();
}

// The multi-axis map: a box of 8 along dx and each of three staging dims
// (8^4 = 4096 elements, 16 a thread), or of 64 along dx and 8 along each of
// two. Four staging dims are refused (core/executor_cuda.py plans
// them for tile_t2d_v): a box of 8^5 elements would leave the SM one block
// of 32 elements a thread and 128 KB of slabs for each staged input.
int launch_multi_axis(const TeParams* p, uint32_t umask, int n_staged, cudaStream_t s) {
  const int nu = __builtin_popcount(umask);
  if (nu == 3) return launch_box<3, 3>(p, umask, n_staged, s);
  if (nu == 2) return launch_box<2, 6>(p, umask, n_staged, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// *path is set to the map kernel launched: 0 tile_copy_t2d, 1 the amortized
// interpreter (tile_t2d_v, tile_map_v), 2 the scalar one, 3 the multi-axis
// form (tile_box_v), 4 the streaming form (tile_stream_v); -1 a reduction. A
// program holding exp or sin is refused unless the map streams.
extern "C" int strided_tile_executor(const TeParams* p, void* stream, int* path) {
  *path = -1;
  if (p->rank < 1 || p->rank > TE_MAX_DIM || p->n_in < 0 || p->n_in > TE_MAX_IN ||
      p->n_out < 1 || p->n_red < 1 || p->body.n_reg < 1 || p->body.n_reg > EW_MAX_REG ||
      (p->compact && (p->red >= 0 || p->body.n_reg > EW_CREG || p->n_in > EW_CREG)))
    return (int)cudaErrorInvalidValue;
  if (streams(p)) {
    const int err = launch_stream(p, (cudaStream_t)stream);
    if (err == cudaSuccess) *path = 4;
    return err;
  }
  if (ew_transcendental(p->body) || (p->red >= 0 && ew_transcendental(p->init)))
    return (int)cudaErrorInvalidValue;
  if (p->red < 0 && p->tdim >= 0) {
    if (p->tdim >= p->rank - 1 || p->n_par != p->rank) return (int)cudaErrorInvalidValue;
    const int64_t tiles = ((p->dims[p->rank - 1] + TX - 1) / TX) *
                          ((p->dims[p->tdim] + TY - 1) / TY) * p->n_out /
                          (p->dims[p->rank - 1] * p->dims[p->tdim]);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    uint32_t umask = 0;  // the staging dims
    int n_staged = 0;
    for (int k = 0; k < p->n_in; ++k) {
      if (p->stage[k] < -1 || p->stage[k] >= p->rank - 1) return (int)cudaErrorInvalidValue;
      if (p->stage[k] >= 0) umask |= 1u << p->stage[k], ++n_staged;
    }
    if (umask && p->compact) {
      const int err = launch_multi_axis(p, umask, n_staged, (cudaStream_t)stream);
      if (err == cudaSuccess) *path = 3;
      return err;
    }
    const bool copy = p->n_in == 1 && p->tmask == 1 && p->body.n_instr == 0 &&
                      p->in[0].type == p->out.type;
    if (copy) {
      if (p->out.type == EW_BF16)
        tile_copy_t2d<__nv_bfloat16><<<(unsigned)tiles, dim3(TX, R2), 0, (cudaStream_t)stream>>>(*p);
      else
        tile_copy_t2d<int32_t><<<(unsigned)tiles, dim3(TX, R2), 0, (cudaStream_t)stream>>>(*p);
      *path = 0;
      return (int)cudaGetLastError();
    }
    const size_t smem = (size_t)__builtin_popcount(p->tmask) * SLOT * sizeof(EwVal);
    if (p->compact) {  // at most EW_CREG staged inputs: under the 48 KB default
      const int regs = p->body.n_reg;  // at least n_in (core/ewise.py::compact)
      TeKernel k = regs <= 2 ? tile_t2d_v<2> : regs == 3 ? tile_t2d_v<3> : tile_t2d_v<4>;
      k<<<(unsigned)tiles, dim3(TX, R2), smem, (cudaStream_t)stream>>>(*p);
      *path = 1;
      return (int)cudaGetLastError();
    }
    static bool smem_raised = false;  // once per process
    if (!smem_raised) {
      cudaError_t err = cudaFuncSetAttribute(tile_executor_t2d,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             TE_MAX_IN * SLOT * (int)sizeof(EwVal));
      if (err != cudaSuccess) return (int)err;
      smem_raised = true;
    }
    tile_executor_t2d<<<(unsigned)tiles, dim3(TX, R2), smem, (cudaStream_t)stream>>>(*p);
    *path = 2;
    return (int)cudaGetLastError();
  }
  if (p->compact) {
    const int64_t blocks = (p->n_out + THREADS * PER - 1) / (THREADS * PER);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int regs = p->body.n_reg;
    TeKernel k = regs <= 2 ? tile_map_v<2> : regs == 3 ? tile_map_v<3> : tile_map_v<4>;
    k<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*p);
    *path = 1;
    return (int)cudaGetLastError();
  }
  // a map: one output element a thread. A reduction: x_lanes outputs a
  // block, the reduced extent over the other 256 / x_lanes threads and over
  // ``chunks`` blocks (the wrapper picks both, and the scratch).
  int X = THREADS, Y = 1, chunks = 1;
  if (p->red >= 0 && p->n_red > 1) {
    X = p->x_lanes;
    chunks = p->chunks;
    if ((X != 1 && X != 8 && X != 32) || chunks < 1 || chunks > 65535 ||
        (chunks > 1 && p->scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    Y = THREADS / X;
  } else if (p->chunks != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (p->n_out + X - 1) / X;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tile_executor_kernel<<<dim3((unsigned)blocks, chunks), dim3(X, Y), 0, s>>>(*p);
  if (p->red < 0) *path = 2;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  tile_executor_merge<<<(unsigned)((p->n_out + THREADS - 1) / THREADS), THREADS, 0, s>>>(*p);
  return (int)cudaGetLastError();
}
