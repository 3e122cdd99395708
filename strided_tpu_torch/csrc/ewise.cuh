// Elementwise programs: the device side of strided_tpu_torch/core/ewise.py.
//
// A closure ``f`` of the engine is traced on the host into a flat program
// (op code, compute type, operand registers, constants), compacted there
// (scalar constants folded into the instruction that reads them as its
// immediate, EW_IMM; registers reused by liveness, so a program needs n_reg
// registers, the most values live at once) and passed to a kernel by value.
// Every thread runs the same instruction sequence, so every switch below is
// warp-uniform.
//
// Three interpreters. ew_run_v<R, E> runs each instruction over a thread's E
// elements (instruction outer, element inner), so its switch is taken once
// per E elements, and keeps the register file as R x E values whose every
// index is a compile-time constant: it lives in registers, never in local
// memory. It takes programs with n_reg <= EW_CREG. ew_run_s<R, E> does the
// same with operands picked by selects per element, not copied behind
// branches (K3's kernels on 1 or 2 registers). ew_run, the scalar
// interpreter, runs one element on a register array indexed at run time
// (local memory) and takes any program; the kernels launch it where n_reg
// is larger.
//
// Arithmetic is IEEE single precision with no contraction (__fadd_rn,
// __fmul_rn, __fdiv_rn), so a program agrees with eager PyTorch bit for bit;
// a bf16 result is rounded after every operation, as eager PyTorch does.
//
// EW_EXP and EW_SIN (the accurate expf and sinf, which torch's own kernels
// call) exist only in the select interpreter instantiated with TR = true:
// K4's streaming map (tile_stream_v). Every other kernel runs an interpreter
// that has no such op, as before the two were added, and its launcher
// refuses a program that holds one (ew_transcendental).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#define EW_MAX_IN 8
#define EW_MAX_INSTR 32
#define EW_MAX_REG (EW_MAX_IN + EW_MAX_INSTR)
#define EW_CREG 4   // registers of the amortized interpreter (ewise.py: CREG)
#define EW_IMM (-1)  // operand: the instruction's immediate (cf, or ci for int/bool)

// types (ewise.py: F32 ...)
enum { EW_F32 = 0, EW_BF16 = 1, EW_I32 = 2, EW_BOOL = 3 };
// ops (ewise.py: CONST ...)
enum {
  EW_CONST, EW_CAST, EW_ADD, EW_SUB, EW_MUL, EW_DIV, EW_DIVC, EW_POW, EW_POWC,
  EW_MOD, EW_MIN, EW_MAX, EW_LT, EW_LE, EW_GT, EW_GE, EW_EQ, EW_NE, EW_NEG,
  EW_ABS, EW_WHERE, EW_EXP, EW_SIN
};
// reductions (executor_cuda.py / stream_reduce.py: RED_SUM ...)
enum { EW_RED_SUM, EW_RED_PROD, EW_RED_MIN, EW_RED_MAX, EW_RED_ALL, EW_RED_ANY };

struct EwInstr {
  int32_t op, type, a, b, c;  // c: WHERE's third operand, CAST's source type
  float cf;
  int32_t ci, dst;
};

struct EwProgram {
  int32_t n_in, n_instr, out, out_type, n_reg;
  int32_t in_type[EW_MAX_IN];
  EwInstr ins[EW_MAX_INSTR];
};

union EwVal {
  float f;
  int32_t i;
};

__host__ __device__ __forceinline__ bool ew_is_float(int t) { return t == EW_F32 || t == EW_BF16; }

// Whether the program holds EW_EXP or EW_SIN (launchers: only TR instances take it).
__host__ __device__ inline bool ew_transcendental(const EwProgram& p) {
  for (int k = 0; k < p.n_instr; ++k)
    if (p.ins[k].op == EW_EXP || p.ins[k].op == EW_SIN) return true;
  return false;
}

__device__ __forceinline__ float ew_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ew_round(float x, int t) {
  return t == EW_BF16 ? ew_bf16(x) : x;
}

__device__ __forceinline__ int32_t ew_wrap(uint32_t x) { return (int32_t)x; }

// A value of type ``from`` as type ``to`` (torch's static_cast rules:
// float -> int truncates; int -> bf16 rounds through f32).
__device__ __forceinline__ EwVal ew_cast(EwVal v, int from, int to) {
  EwVal r;
  if (from == to) return v;
  if (to == EW_BOOL) {
    r.i = ew_is_float(from) ? (v.f != 0.0f) : (v.i != 0);
  } else if (ew_is_float(to)) {
    float f = ew_is_float(from) ? v.f : __int2float_rn(v.i);
    r.f = ew_round(f, to);
  } else {  // EW_I32
    r.i = ew_is_float(from) ? __float2int_rz(v.f) : v.i;
  }
  return r;
}

__device__ __forceinline__ float ew_fmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float ew_fmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ int32_t ew_ipow(int32_t b, int32_t e) {
  uint32_t r = 1u, x = (uint32_t)b;
  while (e > 0) {
    if (e & 1) r *= x;
    x *= x;
    e >>= 1;
  }
  return (int32_t)r;
}

// torch's pow(tensor, scalar) special forms, then powf
__device__ __forceinline__ float ew_powc(float x, float e, int t) {
  if (e == 2.0f) return ew_round(__fmul_rn(x, x), t);
  if (e == 3.0f) return ew_round(__fmul_rn(ew_round(__fmul_rn(x, x), t), x), t);
  if (e == 0.5f) return ew_round(__fsqrt_rn(x), t);
  if (e == -0.5f) return ew_round(rsqrtf(x), t);
  if (e == -1.0f) return ew_round(__fdiv_rn(1.0f, x), t);
  if (e == -2.0f) return ew_round(__fdiv_rn(1.0f, ew_round(__fmul_rn(x, x), t)), t);
  return ew_round(powf(x, e), t);
}

// One binary op of compute type T (EW_F32, EW_BF16 or EW_I32).
template <int OP, int T>
__device__ __forceinline__ EwVal ew_op2(EwVal x, EwVal y) {
  EwVal r;
  if constexpr (T != EW_I32) {
    const float a = x.f, b = y.f;
    if constexpr (OP == EW_LT) r.i = a < b;
    else if constexpr (OP == EW_LE) r.i = a <= b;
    else if constexpr (OP == EW_GT) r.i = a > b;
    else if constexpr (OP == EW_GE) r.i = a >= b;
    else if constexpr (OP == EW_EQ) r.i = a == b;
    else if constexpr (OP == EW_NE) r.i = a != b;
    else {
      float v;
      if constexpr (OP == EW_ADD) v = __fadd_rn(a, b);
      else if constexpr (OP == EW_SUB) v = __fsub_rn(a, b);
      else if constexpr (OP == EW_MUL) v = __fmul_rn(a, b);
      else if constexpr (OP == EW_DIV) v = __fdiv_rn(a, b);
      else if constexpr (OP == EW_POW) v = powf(a, b);
      else if constexpr (OP == EW_MOD) {
        v = fmodf(a, b);
        if (v != 0.0f && ((b < 0.0f) != (v < 0.0f))) v = __fadd_rn(v, b);
      } else if constexpr (OP == EW_MIN) v = ew_fmin(a, b);
      else v = ew_fmax(a, b);  // EW_MAX
      r.f = ew_round(v, T);
    }
  } else {
    const int32_t a = x.i, b = y.i;
    const uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
    if constexpr (OP == EW_ADD) r.i = ew_wrap(ua + ub);
    else if constexpr (OP == EW_SUB) r.i = ew_wrap(ua - ub);
    else if constexpr (OP == EW_MUL) r.i = ew_wrap(ua * ub);
    else if constexpr (OP == EW_POW) r.i = ew_ipow(a, b);
    else if constexpr (OP == EW_MOD) {
      int32_t m = (b == 0 || (a == INT32_MIN && b == -1)) ? 0 : a % b;
      if (m != 0 && ((m < 0) != (b < 0))) m += b;
      r.i = m;
    } else if constexpr (OP == EW_MIN) r.i = a < b ? a : b;
    else if constexpr (OP == EW_MAX) r.i = a > b ? a : b;
    else if constexpr (OP == EW_LT) r.i = a < b;
    else if constexpr (OP == EW_LE) r.i = a <= b;
    else if constexpr (OP == EW_GT) r.i = a > b;
    else if constexpr (OP == EW_GE) r.i = a >= b;
    else if constexpr (OP == EW_EQ) r.i = a == b;
    else if constexpr (OP == EW_NE) r.i = a != b;
    else r.i = 0;  // EW_DIV has a float compute type
  }
  return r;
}

#define EW_CASE2(OP)                                               \
  case OP:                                                         \
    _Pragma("unroll") for (int e = 0; e < E; ++e) r[e] = ew_op2<OP, T>(x[e], y[e]); \
    break;

// A binary op on E elements: one switch, then E operations.
template <int E, int T>
__device__ __forceinline__ void ew_binary_v(int op, const EwVal* x, const EwVal* y, EwVal* r) {
  switch (op) {
    EW_CASE2(EW_ADD) EW_CASE2(EW_SUB) EW_CASE2(EW_MUL) EW_CASE2(EW_DIV) EW_CASE2(EW_POW)
    EW_CASE2(EW_MOD) EW_CASE2(EW_MIN) EW_CASE2(EW_MAX) EW_CASE2(EW_LT) EW_CASE2(EW_LE)
    EW_CASE2(EW_GT) EW_CASE2(EW_GE) EW_CASE2(EW_EQ) EW_CASE2(EW_NE)
    default: break;
  }
}
#undef EW_CASE2

// An instruction's immediate, in the type its operand slots read.
__device__ __forceinline__ EwVal ew_imm(const EwInstr& I) {
  EwVal v;
  if (ew_is_float(I.type)) v.f = I.cf; else v.i = I.ci;
  return v;
}

__device__ __forceinline__ bool ew_reads_b(int op) {
  return op != EW_CONST && op != EW_CAST && op != EW_DIVC && op != EW_POWC && op != EW_NEG &&
         op != EW_ABS;
}

// Instruction I on E elements: operands x, y, z (a, b, c), result r. Each
// element is read before it is written, so r may be x.
template <int E>
__device__ __forceinline__ void ew_apply(const EwInstr& I, const EwVal* x, const EwVal* y,
                                         const EwVal* z, EwVal* r) {
  const int t = I.type;
  const bool fl = ew_is_float(t);
  switch (I.op) {
    case EW_CONST: {
      const EwVal c = ew_imm(I);
#pragma unroll
      for (int e = 0; e < E; ++e) r[e] = c;
      break;
    }
    case EW_CAST:
#pragma unroll
      for (int e = 0; e < E; ++e) r[e] = ew_cast(x[e], I.c, t);
      break;
    case EW_DIVC:
#pragma unroll
      for (int e = 0; e < E; ++e) r[e].f = ew_round(__fmul_rn(x[e].f, I.cf), t);
      break;
    case EW_POWC:
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (fl) r[e].f = ew_powc(x[e].f, I.cf, t);
        else r[e].i = ew_ipow(x[e].i, I.ci);
      }
      break;
    case EW_NEG:
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (fl) r[e].f = -x[e].f;
        else r[e].i = ew_wrap(0u - (uint32_t)x[e].i);
      }
      break;
    case EW_ABS:
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (fl) r[e].f = fabsf(x[e].f);
        else r[e].i = x[e].i < 0 ? ew_wrap(0u - (uint32_t)x[e].i) : x[e].i;
      }
      break;
    case EW_WHERE:
#pragma unroll
      for (int e = 0; e < E; ++e) r[e] = x[e].i ? y[e] : z[e];
      break;
    default:
      if (t == EW_F32) ew_binary_v<E, EW_F32>(I.op, x, y, r);
      else if (t == EW_BF16) ew_binary_v<E, EW_BF16>(I.op, x, y, r);
      else ew_binary_v<E, EW_I32>(I.op, x, y, r);
  }
}

// The scalar interpreter: any compacted program, one element, on registers
// r[0 .. n_reg) with the leaves in r[0 .. n_in); returns the output value.
__device__ __forceinline__ EwVal ew_run(const EwProgram& p, EwVal* r) {
  for (int k = 0; k < p.n_instr; ++k) {
    const EwInstr& I = p.ins[k];
    const EwVal imm = ew_imm(I);
    const EwVal x = I.a == EW_IMM ? imm : r[I.a];
    const EwVal y = I.b == EW_IMM ? imm : r[I.b];
    const EwVal z = I.c == EW_IMM ? imm : r[I.c];  // CAST: c is a type code, read unused
    EwVal v;
    ew_apply<1>(I, &x, &y, &z, &v);
    r[I.dst] = v;
  }
  return r[p.out];
}

// Register k of an R x E register file, for E elements. Every index into
// r is a compile-time constant, so r stays in registers; k is warp-uniform,
// so the switch is a branch, not R x E selects.
template <int R, int E>
__device__ __forceinline__ void ew_reg(const EwVal (&r)[R][E], int k, EwVal* x) {
  static_assert(R >= 1 && R <= 4, "EW_CREG is at most 4");
#define EW_COPY(J, DST, SRC)                                          \
  case J:                                                             \
    if constexpr (R > J) {                                            \
      _Pragma("unroll") for (int e = 0; e < E; ++e) DST = SRC;        \
    }                                                                 \
    break;
  switch (k) {
    EW_COPY(1, x[e], r[1][e]) EW_COPY(2, x[e], r[2][e]) EW_COPY(3, x[e], r[3][e])
    default:
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = r[0][e];
  }
}

template <int R, int E>
__device__ __forceinline__ void ew_set(EwVal (&r)[R][E], int k, const EwVal* v) {
  switch (k) {
    EW_COPY(1, r[1][e], v[e]) EW_COPY(2, r[2][e], v[e]) EW_COPY(3, r[3][e], v[e])
    default:
#pragma unroll
      for (int e = 0; e < E; ++e) r[0][e] = v[e];
  }
}
#undef EW_COPY

// An operand: register k, or the instruction's immediate.
template <int R, int E>
__device__ __forceinline__ void ew_get(const EwVal (&r)[R][E], int k, const EwInstr& I,
                                       EwVal* x) {
  if (k == EW_IMM) {
    const EwVal c = ew_imm(I);
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = c;
    return;
  }
  ew_reg(r, k, x);
}

// The amortized interpreter: a program with n_reg <= R on E elements at
// once, instruction outer and element inner; the leaves are in r[0 .. n_in)
// and the output is left in r[p.out] (read it with ew_reg).
template <int R, int E>
__device__ __forceinline__ void ew_run_v(const EwProgram& p, EwVal (&r)[R][E]) {
#pragma unroll 1
  for (int k = 0; k < p.n_instr; ++k) {
    const EwInstr& I = p.ins[k];
    EwVal x[E], y[E], z[E];
    ew_get(r, I.a, I, x);
    if (ew_reads_b(I.op)) ew_get(r, I.b, I, y);
    if (I.op == EW_WHERE) ew_get(r, I.c, I, z);
    ew_apply<E>(I, x, y, z, x);  // the result in place of operand a
    ew_set(r, I.dst, x);
  }
}

// The select interpreter: like ew_run_v, a program with n_reg <= R on E
// elements at once with the register file in registers, but each operand
// is picked from the R registers by selects element by element instead of
// being copied out behind a branch, and the result written back the same
// way. No E-wide operand copies are live, only the R x E file, and an
// instruction costs one switch on its op; with R = 1 an operand is register
// 0 or the immediate. The leaves are in r[0 .. n_in); read the output with
// ew_sel(r, p.out, e). TR: EW_EXP and EW_SIN too.
template <int R, int E>
__device__ __forceinline__ EwVal ew_sel(const EwVal (&r)[R][E], int k, int e) {
  EwVal v = r[0][e];
#pragma unroll
  for (int j = 1; j < R; ++j)
    if (k == j) v = r[j][e];
  return v;
}

template <int R, int E>
__device__ __forceinline__ EwVal ew_sel(const EwVal (&r)[R][E], int k, EwVal imm, int e) {
  return k == EW_IMM ? imm : ew_sel(r, k, e);
}

template <int R, int E>
__device__ __forceinline__ void ew_put(EwVal (&r)[R][E], int k, int e, EwVal v) {
  if constexpr (R == 1) {
    r[0][e] = v;
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (k == j) r[j][e] = v;
  }
}

#define EW_SCASE2(OP)                                                                \
  case OP:                                                                           \
    _Pragma("unroll") for (int e = 0; e < E; ++e)                                    \
        ew_put(r, d, e, ew_op2<OP, T>(ew_sel(r, a, imm, e), ew_sel(r, b, imm, e)));  \
    break;

template <int R, int E, int T>
__device__ __forceinline__ void ew_binary_s(int op, EwVal (&r)[R][E], int a, int b, int d,
                                            EwVal imm) {
  switch (op) {
    EW_SCASE2(EW_ADD) EW_SCASE2(EW_SUB) EW_SCASE2(EW_MUL) EW_SCASE2(EW_DIV) EW_SCASE2(EW_POW)
    EW_SCASE2(EW_MOD) EW_SCASE2(EW_MIN) EW_SCASE2(EW_MAX) EW_SCASE2(EW_LT) EW_SCASE2(EW_LE)
    EW_SCASE2(EW_GT) EW_SCASE2(EW_GE) EW_SCASE2(EW_EQ) EW_SCASE2(EW_NE)
    default: break;
  }
}
#undef EW_SCASE2

template <int R, int E, bool TR = false>
__device__ __forceinline__ void ew_run_s(const EwProgram& p, EwVal (&r)[R][E]) {
#pragma unroll 1
  for (int k = 0; k < p.n_instr; ++k) {
    const EwInstr& I = p.ins[k];
    const EwVal imm = ew_imm(I);
    const int a = I.a, d = I.dst, t = I.type;
    const bool fl = ew_is_float(t);
    switch (I.op) {
      case EW_CONST:
#pragma unroll
        for (int e = 0; e < E; ++e) ew_put(r, d, e, imm);
        break;
      case EW_CAST: {
        const int from = I.c;
#pragma unroll
        for (int e = 0; e < E; ++e) ew_put(r, d, e, ew_cast(ew_sel(r, a, imm, e), from, t));
        break;
      }
      case EW_DIVC: {
        const float cf = I.cf;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          EwVal v;
          v.f = ew_round(__fmul_rn(ew_sel(r, a, imm, e).f, cf), t);
          ew_put(r, d, e, v);
        }
        break;
      }
      case EW_POWC: {
        const float cf = I.cf;
        const int ci = I.ci;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const EwVal x = ew_sel(r, a, imm, e);
          EwVal v;
          if (fl) v.f = ew_powc(x.f, cf, t);
          else v.i = ew_ipow(x.i, ci);
          ew_put(r, d, e, v);
        }
        break;
      }
      case EW_NEG:
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const EwVal x = ew_sel(r, a, imm, e);
          EwVal v;
          if (fl) v.f = -x.f;
          else v.i = ew_wrap(0u - (uint32_t)x.i);
          ew_put(r, d, e, v);
        }
        break;
      case EW_ABS:
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const EwVal x = ew_sel(r, a, imm, e);
          EwVal v;
          if (fl) v.f = fabsf(x.f);
          else v.i = x.i < 0 ? ew_wrap(0u - (uint32_t)x.i) : x.i;
          ew_put(r, d, e, v);
        }
        break;
      case EW_WHERE: {
        const int b = I.b, c = I.c;
#pragma unroll
        for (int e = 0; e < E; ++e)
          ew_put(r, d, e, ew_sel(r, a, imm, e).i ? ew_sel(r, b, imm, e) : ew_sel(r, c, imm, e));
        break;
      }
      default:
        if constexpr (TR) {
          if (I.op == EW_EXP || I.op == EW_SIN) {
            const bool ex = I.op == EW_EXP;
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float x = ew_sel(r, a, imm, e).f;
              EwVal v;
              v.f = ew_round(ex ? expf(x) : sinf(x), t);
              ew_put(r, d, e, v);
            }
            break;
          }
        }
        if (t == EW_F32) ew_binary_s<R, E, EW_F32>(I.op, r, a, I.b, d, imm);
        else if (t == EW_BF16) ew_binary_s<R, E, EW_BF16>(I.op, r, a, I.b, d, imm);
        else ew_binary_s<R, E, EW_I32>(I.op, r, a, I.b, d, imm);
    }
  }
}

// Load one element of memory type ``t`` as a program value.
__device__ __forceinline__ EwVal ew_load(const void* base, int64_t idx, int t) {
  EwVal v;
  if (t == EW_F32) v.f = __ldg((const float*)base + idx);
  else if (t == EW_BF16) v.f = __bfloat162float(((const __nv_bfloat16*)base)[idx]);
  else v.i = __ldg((const int32_t*)base + idx);
  return v;
}

// E elements of memory type ``t`` at base[idx[e]] where ok[e] (idx: 32-bit
// where the caller knows every offset is below 2^31, else 64-bit). The type
// test is made once, outside the element loop, so the E loads sit in one
// basic block and are all in flight together (f32 and int32 are moved as
// 32-bit words: an EwVal holds either).
template <int E, typename I>
__device__ __forceinline__ void ew_load_v(const void* base, const I* idx, const bool* ok, int t,
                                          EwVal* v) {
  if (t == EW_BF16) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e]) v[e].f = __bfloat162float(((const __nv_bfloat16*)base)[idx[e]]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e]) v[e].i = __ldg((const int32_t*)base + idx[e]);
  }
}

template <int E, typename I>
__device__ __forceinline__ void ew_store_v(void* base, const I* idx, const bool* ok, int t,
                                           const EwVal* v) {
  if (t == EW_BF16) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e]) ((__nv_bfloat16*)base)[idx[e]] = __float2bfloat16_rn(v[e].f);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e]) ((int32_t*)base)[idx[e]] = v[e].i;
  }
}

// Store a value of type ``t`` to memory of the same type.
__device__ __forceinline__ void ew_store(void* base, int64_t idx, int t, EwVal v) {
  if (t == EW_F32) ((float*)base)[idx] = v.f;
  else if (t == EW_BF16) ((__nv_bfloat16*)base)[idx] = __float2bfloat16_rn(v.f);
  else ((int32_t*)base)[idx] = v.i;
}

// Reductions: the identity and one fold step of fold RED on an accumulator
// that is f32 (FL: for float values) or int32. No rounding to bf16 inside
// the fold: the accumulator is f32 and is rounded once.
template <int RED, bool FL>
__device__ __forceinline__ EwVal ew_identity_t() {
  EwVal v;
  if constexpr (RED == EW_RED_SUM) { if (FL) v.f = 0.0f; else v.i = 0; }
  else if constexpr (RED == EW_RED_PROD) { if (FL) v.f = 1.0f; else v.i = 1; }
  else if constexpr (RED == EW_RED_MIN) { if (FL) v.f = __int_as_float(0x7f800000); else v.i = INT32_MAX; }
  else { if (FL) v.f = __int_as_float(0xff800000); else v.i = INT32_MIN; }  // MAX
  return v;
}

template <int RED, bool FL>
__device__ __forceinline__ EwVal ew_fold_t(EwVal acc, EwVal x) {
  if constexpr (RED == EW_RED_SUM) {
    if (FL) acc.f = __fadd_rn(acc.f, x.f); else acc.i = ew_wrap((uint32_t)acc.i + (uint32_t)x.i);
  } else if constexpr (RED == EW_RED_PROD) {
    if (FL) acc.f = __fmul_rn(acc.f, x.f); else acc.i = ew_wrap((uint32_t)acc.i * (uint32_t)x.i);
  } else if constexpr (RED == EW_RED_MIN) {
    if (FL) acc.f = ew_fmin(acc.f, x.f); else acc.i = acc.i < x.i ? acc.i : x.i;
  } else {  // MAX
    if (FL) acc.f = ew_fmax(acc.f, x.f); else acc.i = acc.i > x.i ? acc.i : x.i;
  }
  return acc;
}

// The same, with the fold and type known at run time (K4's reductions; for
// ALL/ANY x is folded by its truth).
__device__ __forceinline__ EwVal ew_red_identity(int red, int t) {
  const bool fl = ew_is_float(t);
  EwVal v;
  switch (red) {
    case EW_RED_SUM: return fl ? ew_identity_t<EW_RED_SUM, true>() : ew_identity_t<EW_RED_SUM, false>();
    case EW_RED_PROD: return fl ? ew_identity_t<EW_RED_PROD, true>() : ew_identity_t<EW_RED_PROD, false>();
    case EW_RED_MIN: return fl ? ew_identity_t<EW_RED_MIN, true>() : ew_identity_t<EW_RED_MIN, false>();
    case EW_RED_MAX: return fl ? ew_identity_t<EW_RED_MAX, true>() : ew_identity_t<EW_RED_MAX, false>();
    case EW_RED_ALL: v.i = 1; return v;
    default: v.i = 0; return v;  // ANY
  }
}

__device__ __forceinline__ EwVal ew_red_fold(int red, int t, EwVal acc, EwVal x) {
  const bool fl = ew_is_float(t);
  switch (red) {
    case EW_RED_SUM: return fl ? ew_fold_t<EW_RED_SUM, true>(acc, x) : ew_fold_t<EW_RED_SUM, false>(acc, x);
    case EW_RED_PROD: return fl ? ew_fold_t<EW_RED_PROD, true>(acc, x) : ew_fold_t<EW_RED_PROD, false>(acc, x);
    case EW_RED_MIN: return fl ? ew_fold_t<EW_RED_MIN, true>(acc, x) : ew_fold_t<EW_RED_MIN, false>(acc, x);
    case EW_RED_MAX: return fl ? ew_fold_t<EW_RED_MAX, true>(acc, x) : ew_fold_t<EW_RED_MAX, false>(acc, x);
    case EW_RED_ALL: acc.i = acc.i && (fl ? x.f != 0.0f : x.i != 0); return acc;
    default: acc.i = acc.i || (fl ? x.f != 0.0f : x.i != 0); return acc;  // ANY
  }
}

// Fold two accumulators (partials of one reduction) in a fixed order.
__device__ __forceinline__ EwVal ew_red_merge(int red, int t, EwVal acc, EwVal x) {
  if (red == EW_RED_ALL || red == EW_RED_ANY) {
    EwVal r;
    r.i = red == EW_RED_ALL ? (acc.i && x.i) : (acc.i || x.i);
    return r;
  }
  return ew_red_fold(red, t, acc, x);
}
