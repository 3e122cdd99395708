// Shared by the quadrotor's kernels (quadrotor_rk4.cu, quadrotor_jac.cu): the
// state and input widths, the arithmetic of the eager step as PyTorch's CUDA
// kernels round it, one operation at a time, and the part of the dynamics
// that reads the attitude, so that the two kernels' primals are one code.
#pragma once

#include <cuda_runtime.h>

namespace quad {

constexpr int kStates = 12;
constexpr int kInputs = 4;

// each operation rounded on its own, in the element type
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ float tan_(float a) { return tanf(a); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ double tan_(double a) { return tan(a); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }

// a b - c d as torch.linalg.cross's CUDA kernel computes it (quadrotor_rk4.cu's header)
template <typename T>
__device__ __forceinline__ T cross_term(T a, T b, T c, T d) {
  return fma_(a, b, -mul(c, d));
}

// clamp(c, min=1e-6) as torch.clamp computes it: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_cos(T c) {
  return isnan(c) ? c : max_(c, T(1e-6));
}

// The values of models/quadrotor.py::dynamics that depend on the attitude
// and body rates: what the plant kernel needs for the derivatives and the
// Jacobian kernel for their tangents.
template <typename T>
struct Attitude {
  T cphi, sphi, cth, sth, cpsi, spsi;
  T a0, c0, a1, c1;  // cpsi sth, spsi sphi, spsi sth, cpsi sphi
  T zb0, zb1, zb2;   // the body z axis in the world frame (ZYX Euler)
  T tth, e, h;       // tan(theta), sphi tth, cphi tth
  T c;               // clamp(cos(theta), min=1e-6)
  T jp, jq, jr;      // J w
};

// The rotational half of dynamics: at w = (phi, theta, psi, p, q, r) and the
// input u, their derivatives in time k[0..5] (the Euler-angle kinematics and
// J w_dot = tau - w x (J w)), and the values above, each operation in the
// order of models/quadrotor.py.
template <typename T>
__device__ __forceinline__ Attitude<T> rotation(const T* w, const T (&u)[kInputs], T Jx, T Jy,
                                                T Jz, T* k) {
  Attitude<T> a;
  const T phi = w[0], th = w[1], psi = w[2];
  const T p = w[3], q = w[4], r = w[5];
  a.cphi = cos_(phi), a.sphi = sin_(phi);
  a.cth = cos_(th), a.sth = sin_(th);
  a.cpsi = cos_(psi), a.spsi = sin_(psi);
  a.a0 = mul(a.cpsi, a.sth), a.c0 = mul(a.spsi, a.sphi);
  a.a1 = mul(a.spsi, a.sth), a.c1 = mul(a.cpsi, a.sphi);
  a.zb0 = add(mul(a.a0, a.cphi), a.c0);
  a.zb1 = sub(mul(a.a1, a.cphi), a.c1);
  a.zb2 = mul(a.cth, a.cphi);
  // Euler-angle kinematics
  a.tth = tan_(th);
  a.e = mul(a.sphi, a.tth), a.h = mul(a.cphi, a.tth);
  k[0] = add(add(p, mul(a.e, q)), mul(a.h, r));
  k[1] = sub(mul(a.cphi, q), mul(a.sphi, r));
  a.c = clamp_cos(a.cth);
  k[2] = quo(add(mul(a.sphi, q), mul(a.cphi, r)), a.c);
  // J w_dot = tau - w x (J w)
  a.jp = mul(Jx, p), a.jq = mul(Jy, q), a.jr = mul(Jz, r);
  k[3] = quo(sub(u[1], cross_term(q, a.jr, r, a.jq)), Jx);
  k[4] = quo(sub(u[2], cross_term(r, a.jp, p, a.jr)), Jy);
  k[5] = quo(sub(u[3], cross_term(p, a.jq, q, a.jp)), Jz);
  return a;
}

}  // namespace quad
