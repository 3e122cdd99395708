// The 12-state quadrotor's RK4 step, one thread a quadrotor (sm_90a), in f32
// and in f64.
//
// Replaces no TPU kernel: the reference leaves the plant to XLA, which fuses
// strided_tpu/models/base.py::rk4_step on quadrotor.py::dynamics inside its
// jitted step. Eager PyTorch runs the same step as about 130 elementwise
// kernels, each a pass over the batch; inside the captured MPC step they took
// 0.257 ms a period at B = 16384, as long as K1. Here a thread loads its row's
// 12 states and 4 inputs into registers, runs the four evaluations of the
// dynamics and the RK4 combination there, and writes the 12 next states.
// Rows are read through their row and column strides, so a slice of a
// trajectory (us[..., t, :]) or a state broadcast along the rows (stride 0)
// is read where it lies; the next states are written contiguous.
//
// What bounds it: neither the bytes (16384 x 28 floats, 1.8 MB: 0.55 us at
// 3.35 TB/s) nor the FP32 and SFU work (about 1,300 instructions a row), but
// the latency of one thread's dependent chain: four stages, each the sine and
// cosine of three angles, a tangent, then the products that use them. So the
// design spreads the rows as thinly as the card allows: blocks of 128
// threads put the main path's 16384 rows in 128 blocks, at most one on each
// of the 132 SMs, and a block's four warps go one to each of the SM's four
// schedulers. Larger blocks would leave SMs idle (256 threads: 64 blocks);
// nothing is shared between threads, so nothing else sets the block size.
//
// The arithmetic is the eager step's on the card, term for term, so the two
// agree bit for bit (in f32 measured; f64 is the same code on doubles):
//
// * every product, sum and quotient rounded on its own (__fmul_rn,
//   __fadd_rn, __fsub_rn, __fdiv_rn), as each eager op rounds its result, so
//   nvcc contracts nothing into an FMA, in the order of models/quadrotor.py
//   and models/base.py: x + (0.5 dt) k1, x + dt k3, ((k1 + 2 k2) + 2 k3) +
//   k4, ((cpsi sth) cphi) + (spsi sphi);
// * the cross product w x (J w) as PyTorch's CUDA cross kernel computes it:
//   its a1 b2 - a2 b1 is one kernel, which nvcc contracts to
//   fma(a1, b2, -(a2 b1)) (measured: torch 2.11 for CUDA 12.8 on an H100,
//   every element of 2^20 random products), so here it is that FMA. With
//   each product rounded on its own instead, 0.4% of the next states moved
//   by up to 4 ulps, and by 1087 where cos(theta) is clamped;
// * the precise sinf, cosf and tanf (no __sinf, no fast math);
// * thrust / m as PyTorch's CUDA division by a Python scalar computes it:
//   thrust times 1 / m, the reciprocal taken in double on the host and
//   rounded to f32 (measured as above; 1.0f / f32(m) differs at m = 1.7);
// * clamp(cos theta, min=1e-6) keeps a NaN, as torch.clamp does;
// * gravity's x and y terms are zeros: a - 0 is a, so they are left out.
//
// The step scalars 0.5 dt, dt and dt / 6, and 1 / m, come from the host,
// computed in double as Python does and, for f32, rounded as PyTorch rounds
// a Python scalar for an f32 tensor. The body's constants are arguments, so
// any quadrotor(m=...) runs.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
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

// a b - c d as torch.linalg.cross's CUDA kernel computes it (the header)
template <typename T>
__device__ __forceinline__ T cross_term(T a, T b, T c, T d) {
  return fma_(a, b, -mul(c, d));
}

template <typename T>
struct Body {
  T inv_m, g, Jx, Jy, Jz;
};

// k = dynamics(s, u): models/quadrotor.py::dynamics. State [p, v, (phi,
// theta, psi), (p, q, r) body rates]; input [thrust, tau_x, tau_y, tau_z].
template <typename T>
__device__ __forceinline__ void dynamics(const T (&s)[kStates], const T (&u)[kInputs],
                                         const Body<T>& b, T (&k)[kStates]) {
  const T phi = s[6], th = s[7], psi = s[8];
  const T p = s[9], q = s[10], r = s[11];
  const T cphi = cos_(phi), sphi = sin_(phi);
  const T cth = cos_(th), sth = sin_(th);
  const T cpsi = cos_(psi), spsi = sin_(psi);

  k[0] = s[3];
  k[1] = s[4];
  k[2] = s[5];
  // body z axis in the world frame (ZYX Euler) times thrust / m, less gravity
  const T tm = mul(u[0], b.inv_m);
  k[3] = mul(add(mul(mul(cpsi, sth), cphi), mul(spsi, sphi)), tm);
  k[4] = mul(sub(mul(mul(spsi, sth), cphi), mul(cpsi, sphi)), tm);
  k[5] = sub(mul(mul(cth, cphi), tm), b.g);
  // Euler-angle kinematics
  const T tth = tan_(th);
  k[6] = add(add(p, mul(mul(sphi, tth), q)), mul(mul(cphi, tth), r));
  k[7] = sub(mul(cphi, q), mul(sphi, r));
  const T c = isnan(cth) ? cth : max_(cth, T(1e-6));
  k[8] = quo(add(mul(sphi, q), mul(cphi, r)), c);
  // J w_dot = tau - w x (J w)
  const T jp = mul(b.Jx, p), jq = mul(b.Jy, q), jr = mul(b.Jz, r);
  k[9] = quo(sub(u[1], cross_term(q, jr, r, jq)), b.Jx);
  k[10] = quo(sub(u[2], cross_term(r, jp, p, jr)), b.Jy);
  k[11] = quo(sub(u[3], cross_term(p, jq, q, jp)), b.Jz);
}

// x and u read through (row, column) strides in elements; out contiguous
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quadrotor_rk4_kernel(const T* __restrict__ x, long long x_row, long long x_col,
                         const T* __restrict__ u, long long u_row, long long u_col,
                         T* __restrict__ out, long long rows, Body<T> b, T half_dt, T dt,
                         T sixth_dt) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const T* xr = x + row * x_row;
  const T* ur = u + row * u_row;
  T x0[kStates], in[kInputs], s[kStates], k[kStates], sum[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) x0[i] = __ldg(xr + i * x_col);
#pragma unroll
  for (int i = 0; i < kInputs; ++i) in[i] = __ldg(ur + i * u_col);

  dynamics(x0, in, b, k);  // k1
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    sum[i] = k[i];
    s[i] = add(x0[i], mul(half_dt, k[i]));
  }
  dynamics(s, in, b, k);  // k2
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    sum[i] = add(sum[i], mul(T(2), k[i]));
    s[i] = add(x0[i], mul(half_dt, k[i]));
  }
  dynamics(s, in, b, k);  // k3
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    sum[i] = add(sum[i], mul(T(2), k[i]));
    s[i] = add(x0[i], mul(dt, k[i]));
  }
  dynamics(s, in, b, k);  // k4
  T* o = out + row * kStates;
#pragma unroll
  for (int i = 0; i < kStates; ++i) o[i] = add(x0[i], mul(sixth_dt, add(sum[i], k[i])));
}

template <typename T>
int launch(const T* x, long long x_row, long long x_col, const T* u, long long u_row,
           long long u_col, T* out, long long rows, Body<T> b, T half_dt, T dt, T sixth_dt,
           void* stream) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (rows < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  quadrotor_rk4_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, x_row, x_col, u, u_row, u_col, out, rows, b, half_dt, dt, sixth_dt);
  return cudaGetLastError();
}

}  // namespace

// One RK4 step of `rows` quadrotors: row i of x (12 states) and of u (4
// inputs) at x + i x_row + j x_col and u + i u_row + j u_col (strides in
// elements, 0 for a row broadcast); out (rows, 12) row-major and contiguous,
// not overlapping x or u. All on the card. Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int strided_quadrotor_rk4_f32(const float* x, long long x_row, long long x_col,
                                         const float* u, long long u_row, long long u_col,
                                         float* out, long long rows, float inv_m, float g,
                                         float Jx, float Jy, float Jz, float half_dt, float dt,
                                         float sixth_dt, void* stream) {
  return launch(x, x_row, x_col, u, u_row, u_col, out, rows, Body<float>{inv_m, g, Jx, Jy, Jz},
                half_dt, dt, sixth_dt, stream);
}

// The same step in f64.
extern "C" int strided_quadrotor_rk4_f64(const double* x, long long x_row, long long x_col,
                                         const double* u, long long u_row, long long u_col,
                                         double* out, long long rows, double inv_m, double g,
                                         double Jx, double Jy, double Jz, double half_dt,
                                         double dt, double sixth_dt, void* stream) {
  return launch(x, x_row, x_col, u, u_row, u_col, out, rows,
                Body<double>{inv_m, g, Jx, Jy, Jz}, half_dt, dt, sixth_dt, stream);
}
