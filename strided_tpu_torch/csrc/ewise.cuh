// Elementwise programs, interpreted per element in registers.
//
// The device side of strided_tpu_torch/core/ewise.py: a closure ``f`` of the
// engine is traced on the host into a flat program (op code, compute type,
// operand registers, constants) and passed to a kernel by value. Every
// thread runs the same instruction sequence, so the switch is warp-uniform;
// the kernels that use it (stream_reduce.cu, tile_executor.cu) are bound by
// memory traffic, and the interpretation hides under the loads.
//
// Arithmetic is IEEE single precision with no contraction (__fadd_rn,
// __fmul_rn, __fdiv_rn), so a program agrees with eager PyTorch bit for bit;
// a bf16 result is rounded after every operation, as eager PyTorch does.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#define EW_MAX_IN 8
#define EW_MAX_INSTR 32
#define EW_MAX_REG (EW_MAX_IN + EW_MAX_INSTR)

// types (ewise.py: F32 ...)
enum { EW_F32 = 0, EW_BF16 = 1, EW_I32 = 2, EW_BOOL = 3 };
// ops (ewise.py: CONST ...)
enum {
  EW_CONST, EW_CAST, EW_ADD, EW_SUB, EW_MUL, EW_DIV, EW_DIVC, EW_POW, EW_POWC,
  EW_MOD, EW_MIN, EW_MAX, EW_LT, EW_LE, EW_GT, EW_GE, EW_EQ, EW_NE, EW_NEG,
  EW_ABS, EW_WHERE
};
// reductions (executor_cuda.py / stream_reduce.py: RED_SUM ...)
enum { EW_RED_SUM, EW_RED_PROD, EW_RED_MIN, EW_RED_MAX, EW_RED_ALL, EW_RED_ANY };

struct EwInstr {
  int32_t op, type, a, b, c;
  float cf;
  int32_t ci, pad;
};

struct EwProgram {
  int32_t n_in, n_instr, out, out_type;
  int32_t in_type[EW_MAX_IN];
  EwInstr ins[EW_MAX_INSTR];
};

union EwVal {
  float f;
  int32_t i;
};

__device__ __forceinline__ bool ew_is_float(int t) { return t == EW_F32 || t == EW_BF16; }

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

__device__ __forceinline__ EwVal ew_binary(int op, int t, EwVal x, EwVal y) {
  EwVal r;
  if (ew_is_float(t)) {
    float a = x.f, b = y.f, v;
    switch (op) {
      case EW_ADD: v = __fadd_rn(a, b); break;
      case EW_SUB: v = __fsub_rn(a, b); break;
      case EW_MUL: v = __fmul_rn(a, b); break;
      case EW_DIV: v = __fdiv_rn(a, b); break;
      case EW_POW: v = powf(a, b); break;
      case EW_MOD: {
        v = fmodf(a, b);
        if (v != 0.0f && ((b < 0.0f) != (v < 0.0f))) v = __fadd_rn(v, b);
        break;
      }
      case EW_MIN: v = ew_fmin(a, b); break;
      case EW_MAX: v = ew_fmax(a, b); break;
      case EW_LT: r.i = a < b; return r;
      case EW_LE: r.i = a <= b; return r;
      case EW_GT: r.i = a > b; return r;
      case EW_GE: r.i = a >= b; return r;
      case EW_EQ: r.i = a == b; return r;
      case EW_NE: r.i = a != b; return r;
      default: v = 0.0f;
    }
    r.f = ew_round(v, t);
    return r;
  }
  int32_t a = x.i, b = y.i;
  uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
  switch (op) {
    case EW_ADD: r.i = ew_wrap(ua + ub); break;
    case EW_SUB: r.i = ew_wrap(ua - ub); break;
    case EW_MUL: r.i = ew_wrap(ua * ub); break;
    case EW_POW: r.i = ew_ipow(a, b); break;
    case EW_MOD: {
      int32_t m = (b == 0 || (a == INT32_MIN && b == -1)) ? 0 : a % b;
      if (m != 0 && ((m < 0) != (b < 0))) m += b;
      r.i = m;
      break;
    }
    case EW_MIN: r.i = a < b ? a : b; break;
    case EW_MAX: r.i = a > b ? a : b; break;
    case EW_LT: r.i = a < b; break;
    case EW_LE: r.i = a <= b; break;
    case EW_GT: r.i = a > b; break;
    case EW_GE: r.i = a >= b; break;
    case EW_EQ: r.i = a == b; break;
    case EW_NE: r.i = a != b; break;
    default: r.i = 0;
  }
  return r;
}

// Run the program on registers r[0 .. n_in) (the leaves); returns the
// value of the output register, of type p.out_type.
__device__ __forceinline__ EwVal ew_run(const EwProgram& p, EwVal* r) {
  const int n_in = p.n_in;
  for (int k = 0; k < p.n_instr; ++k) {
    const EwInstr& I = p.ins[k];
    EwVal v;
    switch (I.op) {
      case EW_CONST:
        if (ew_is_float(I.type)) v.f = I.cf; else v.i = I.ci;
        break;
      case EW_CAST: v = ew_cast(r[I.a], I.c, I.type); break;
      case EW_DIVC: v.f = ew_round(__fmul_rn(r[I.a].f, I.cf), I.type); break;
      case EW_POWC:
        if (ew_is_float(I.type)) v.f = ew_powc(r[I.a].f, I.cf, I.type);
        else v.i = ew_ipow(r[I.a].i, I.ci);
        break;
      case EW_NEG:
        if (ew_is_float(I.type)) v.f = -r[I.a].f; else v.i = ew_wrap(0u - (uint32_t)r[I.a].i);
        break;
      case EW_ABS:
        if (ew_is_float(I.type)) v.f = fabsf(r[I.a].f);
        else v.i = r[I.a].i < 0 ? ew_wrap(0u - (uint32_t)r[I.a].i) : r[I.a].i;
        break;
      case EW_WHERE: v = r[I.a].i ? r[I.b] : r[I.c]; break;
      default: v = ew_binary(I.op, I.type, r[I.a], r[I.b]);
    }
    r[n_in + k] = v;
  }
  return r[p.out];
}

// The same, as a call: a kernel that runs the program at many unrolled
// sites (stream_reduce.cu) keeps one copy of the interpreter and its
// registers instead of one per site.
static __device__ __noinline__ EwVal ew_run_call(const EwProgram& p, EwVal* r) {
  return ew_run(p, r);
}

// Load one element of memory type ``t`` as a program value.
__device__ __forceinline__ EwVal ew_load(const void* base, int64_t idx, int t) {
  EwVal v;
  if (t == EW_F32) v.f = __ldg((const float*)base + idx);
  else if (t == EW_BF16) v.f = __bfloat162float(((const __nv_bfloat16*)base)[idx]);
  else v.i = __ldg((const int32_t*)base + idx);
  return v;
}

// Store a value of type ``t`` to memory of the same type.
__device__ __forceinline__ void ew_store(void* base, int64_t idx, int t, EwVal v) {
  if (t == EW_F32) ((float*)base)[idx] = v.f;
  else if (t == EW_BF16) ((__nv_bfloat16*)base)[idx] = __float2bfloat16_rn(v.f);
  else ((int32_t*)base)[idx] = v.i;
}

// Reductions: the identity and one fold step on an accumulator of type t
// (f32 for float values, int32 for int, 0/1 for ALL/ANY). No rounding to
// bf16 inside the fold: the accumulator is f32 and is rounded once.
__device__ __forceinline__ EwVal ew_red_identity(int red, int t) {
  EwVal v;
  bool fl = ew_is_float(t);
  switch (red) {
    case EW_RED_SUM: if (fl) v.f = 0.0f; else v.i = 0; break;
    case EW_RED_PROD: if (fl) v.f = 1.0f; else v.i = 1; break;
    case EW_RED_MIN: if (fl) v.f = __int_as_float(0x7f800000); else v.i = INT32_MAX; break;
    case EW_RED_MAX: if (fl) v.f = __int_as_float(0xff800000); else v.i = INT32_MIN; break;
    case EW_RED_ALL: v.i = 1; break;
    default: v.i = 0;  // ANY
  }
  return v;
}

// Fold value x (of type t; for ALL/ANY its truth) into acc.
__device__ __forceinline__ EwVal ew_red_fold(int red, int t, EwVal acc, EwVal x) {
  bool fl = ew_is_float(t);
  switch (red) {
    case EW_RED_SUM:
      if (fl) acc.f = __fadd_rn(acc.f, x.f); else acc.i = ew_wrap((uint32_t)acc.i + (uint32_t)x.i);
      break;
    case EW_RED_PROD:
      if (fl) acc.f = __fmul_rn(acc.f, x.f); else acc.i = ew_wrap((uint32_t)acc.i * (uint32_t)x.i);
      break;
    case EW_RED_MIN:
      if (fl) acc.f = ew_fmin(acc.f, x.f); else acc.i = acc.i < x.i ? acc.i : x.i;
      break;
    case EW_RED_MAX:
      if (fl) acc.f = ew_fmax(acc.f, x.f); else acc.i = acc.i > x.i ? acc.i : x.i;
      break;
    case EW_RED_ALL: acc.i = acc.i && (fl ? x.f != 0.0f : x.i != 0); break;
    default: acc.i = acc.i || (fl ? x.f != 0.0f : x.i != 0);
  }
  return acc;
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
