// The Jacobians of the 12-state quadrotor's RK4 step (sm_90a), in f32 and in
// f64: A = dx+/dx (12 x 12) and B = dx+/du (12 x 4) at each of `rows` points
// (x, u), for the iLQR iteration's linearization along a trajectory.
//
// Replaces no TPU kernel: the reference leaves the Jacobians to XLA
// (strided_tpu/models/base.py::linearize, jax.jacfwd vmapped over the
// points). The port's plain version is the same vmap(jacfwd) over the eager
// step on dual tensors: about 1,300 elementwise kernels over 16 tangents a
// point, about 40 GB of traffic at 204,800 points (4096 quadrotors x 50
// stages), 14.4 ms of a 28 ms iLQR period.
//
// What it computes: forward-mode tangent propagation through the four
// evaluations of models/quadrotor.py::dynamics and the RK4 combination of
// models/base.py::rk4_step, along 16 directions (the 12 states, then the 4
// inputs). The primal is quadrotor_rk4.cu's arithmetic. Each tangent follows
// the rule PyTorch's forward mode applies to that operation
// (tools/autograd/derivatives.yaml): (a b)' = b' a + a' b; (a / b)' = (a' -
// b' (a / b)) / b; sin' = t cos, cos' = t (-sin), tan' = t (1 + tan^2), all
// from values the primal already has; clamp(c, min=1e-6)' = c' where c >=
// 1e-6, else 0 (a NaN included); cross(a, b)' = cross(a', b) + cross(a, b');
// a product with a constant (J, 1 / m, dt) is a' times it. Each operation is
// rounded on its own, as each eager kernel rounds, with no fast math and the
// precise sinf, cosf and tanf, so the kernel keeps the plain version's
// accuracy. The dynamics read neither positions nor velocities beyond
// passing the velocities on, and gravity drops out of every derivative, so
// the primal runs only the angles and body rates (quadrotor_ops.cuh's
// rotation, which the plant kernel runs too), and g is no argument.
// A's columns are written dense, in the layout vmap(jacfwd) returns.
//
// What bounds it: not the bytes (204,800 points read 64 bytes and write 768
// in f32: 170 MB, 0.051 ms at 3.35 TB/s) but the instructions: about 150 a
// direction a stage, four IEEE divisions among them, each operation rounded
// on its own (no FMA), and the primal's 28 precise sines, cosines and
// tangents a point, which every thread of a point's group recomputes. One
// thread holding all 16 tangents would keep about 600 live floats and spill,
// so a group of 8 neighbouring threads shares a point, each carrying 2
// directions (kWidth), the lanes taking A's column blocks, then B's, in
// order: a lane writes each row of its block as one 8-byte store (two
// floats), a group whole rows. Points are read through (outer, row, column)
// strides, so the iteration's xs[..., :-1, :] (a slice of the (batch, T + 1,
// 12) trajectory) is read where it lies.
//
// Group widths measured at 204,800 points in f32 (the iteration's slice of a
// (4096, 51, 12) trajectory), device time over 200 launches, four runs in
// turns, on an NVIDIA H100 80GB HBM3 at 700 W; registers from ptxas, no
// spills at any width. The readings at 1 and 4 come from a probe build of
// this kernel with kWidth at those values, not kept in the repository: to
// repeat them, set kWidth (any divisor of 4) and time base.linearize there.
//   1 direction a thread (16 threads a point):  80 registers, 0.3185-0.3190 ms
//   2 directions (8 threads a point):          101 registers, 0.3135-0.3135 ms
//   4 directions (4 threads a point):          192 registers, 0.4464-0.4475 ms
// Two directions are kept, in f64 too (196 registers, no spills): at four the
// registers leave 8 warps an SM, too few to hide the dependent chains; at
// one the primal is recomputed 16 times a point. vmap(jacfwd) took 26.99 ms
// at the same size, uncaptured.
#include <climits>

#include "quadrotor_ops.cuh"

namespace {

using namespace quad;

constexpr int kThreads = 128;
constexpr int kDirections = kStates + kInputs;

template <typename T>
struct Rigid {
  T inv_m, Jx, Jy, Jz;
};

constexpr int kWidth = 2;                     // directions a thread (the header's readings)
constexpr int kGroup = kDirections / kWidth;  // threads a point
static_assert(kStates % kWidth == 0 && kInputs % kWidth == 0 && kThreads % kGroup == 0,
              "a lane's directions lie in A or in B alone, a point's group in one block");

// a lane's kWidth entries of one row of A or B, stored at once
template <typename T>
struct alignas(sizeof(T) * kWidth) Lanes {
  T v[kWidth];
};

// Direction j's seed at state (or input) i: 1 on the diagonal, else 0.
template <typename T>
__device__ __forceinline__ T seed(int i, int j) {
  return i == j ? T(1) : T(0);
}

// One evaluation of dynamics(s, u) with kWidth tangents. s holds (phi,
// theta, psi, p, q, r), k their derivatives in time (the primal the tangents
// need); ds[d] the stage's tangent in direction d (positions unread), du[d]
// the input's; dk[d] the tangent of the whole xdot.
template <typename T>
__device__ __forceinline__ void dynamics_jvp(const T (&s)[6], const T (&u)[kInputs],
                                             const T (&ds)[kWidth][kStates],
                                             const T (&du)[kWidth][kInputs], const Rigid<T>& b,
                                             T (&k)[6], T (&dk)[kWidth][kStates]) {
  const Attitude<T> a = rotation(s, u, b.Jx, b.Jy, b.Jz, k);
  const T cphi = a.cphi, sphi = a.sphi, cth = a.cth, sth = a.sth, cpsi = a.cpsi, spsi = a.spsi;
  const T a0 = a.a0, a1 = a.a1, zb0 = a.zb0, zb1 = a.zb1, zb2 = a.zb2;
  const T tth = a.tth, e = a.e, h = a.h, c = a.c, jp = a.jp, jq = a.jq, jr = a.jr;
  const T p = s[3], q = s[4], r = s[5];
  const T tm = mul(u[0], b.inv_m);

  const T dtan = add(T(1), mul(tth, tth));
  const bool passes = cth >= T(1e-6);  // false for a NaN too
#pragma unroll
  for (int d = 0; d < kWidth; ++d) {
    const T* t = ds[d];
    const T dphi = t[6], dth = t[7], dpsi = t[8], dp = t[9], dq = t[10], dr = t[11];
    const T dcphi = mul(dphi, -sphi), dsphi = mul(dphi, cphi);
    const T dcth = mul(dth, -sth), dsth = mul(dth, cth);
    const T dcpsi = mul(dpsi, -spsi), dspsi = mul(dpsi, cpsi);
    dk[d][0] = t[3];
    dk[d][1] = t[4];
    dk[d][2] = t[5];
    const T da0 = add(mul(dsth, cpsi), mul(dcpsi, sth));
    const T dc0 = add(mul(dsphi, spsi), mul(dspsi, sphi));
    const T dzb0 = add(add(mul(dcphi, a0), mul(da0, cphi)), dc0);
    const T da1 = add(mul(dsth, spsi), mul(dspsi, sth));
    const T dc1 = add(mul(dsphi, cpsi), mul(dcpsi, sphi));
    const T dzb1 = sub(add(mul(dcphi, a1), mul(da1, cphi)), dc1);
    const T dzb2 = add(mul(dcphi, cth), mul(dcth, cphi));
    const T dtm = mul(du[d][0], b.inv_m);
    dk[d][3] = add(mul(dtm, zb0), mul(dzb0, tm));
    dk[d][4] = add(mul(dtm, zb1), mul(dzb1, tm));
    dk[d][5] = add(mul(dtm, zb2), mul(dzb2, tm));
    const T dtth = mul(dth, dtan);
    const T de = add(mul(dtth, sphi), mul(dsphi, tth));
    const T dh = add(mul(dtth, cphi), mul(dcphi, tth));
    dk[d][6] = add(add(dp, add(mul(dq, e), mul(de, q))), add(mul(dr, h), mul(dh, r)));
    dk[d][7] = sub(add(mul(dq, cphi), mul(dcphi, q)), add(mul(dr, sphi), mul(dsphi, r)));
    const T dn = add(add(mul(dq, sphi), mul(dsphi, q)), add(mul(dr, cphi), mul(dcphi, r)));
    const T dc = passes ? dcth : T(0);
    dk[d][8] = quo(sub(dn, mul(dc, k[2])), c);
    const T djp = mul(dp, b.Jx), djq = mul(dq, b.Jy), djr = mul(dr, b.Jz);
    const T dx0 = add(cross_term(dq, jr, dr, jq), cross_term(q, djr, r, djq));
    const T dx1 = add(cross_term(dr, jp, dp, jr), cross_term(r, djp, p, djr));
    const T dx2 = add(cross_term(dp, jq, dq, jp), cross_term(p, djq, q, djp));
    dk[d][9] = quo(sub(du[d][1], dx0), b.Jx);
    dk[d][10] = quo(sub(du[d][2], dx1), b.Jy);
    dk[d][11] = quo(sub(du[d][3], dx2), b.Jz);
  }
}

// Point `row` = o inner + t at x + o x_outer + t x_row (+ i x_col), and u
// alike; A (rows, 12, 12) and B (rows, 12, 4) contiguous. Lane g of a
// point's group carries directions g kWidth .. g kWidth + kWidth - 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quadrotor_jac_kernel(const T* __restrict__ x, long long x_outer, long long x_row,
                         long long x_col, const T* __restrict__ u, long long u_outer,
                         long long u_row, long long u_col, T* __restrict__ A,
                         T* __restrict__ B, long long inner, long long rows, Rigid<T> b,
                         T half_dt, T dt, T sixth_dt) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = tid / kGroup;
  const int j0 = static_cast<int>(tid % kGroup) * kWidth;
  if (row >= rows) return;
  const long long o = row / inner, t = row - o * inner;
  const T* xr = x + o * x_outer + t * x_row;
  const T* ur = u + o * u_outer + t * u_row;
  T s0[6], in[kInputs];
#pragma unroll
  for (int i = 0; i < 6; ++i) s0[i] = __ldg(xr + (6 + i) * x_col);
#pragma unroll
  for (int i = 0; i < kInputs; ++i) in[i] = __ldg(ur + i * u_col);

  T s[6], k[6], ds[kWidth][kStates], du[kWidth][kInputs], dk[kWidth][kStates],
      dsum[kWidth][kStates];
#pragma unroll
  for (int d = 0; d < kWidth; ++d) {
#pragma unroll
    for (int i = 0; i < kStates; ++i) ds[d][i] = seed<T>(i, j0 + d);
#pragma unroll
    for (int i = 0; i < kInputs; ++i) du[d][i] = seed<T>(kStates + i, j0 + d);
  }

  // k1, then the stages s = s0 + c k at c = dt / 2, dt / 2, dt and the sum
  // ((k1 + 2 k2) + 2 k3) + k4, as the plant kernel forms them, with their
  // tangents; dk holds k4's at the end
  dynamics_jvp(s0, in, ds, du, b, k, dk);
  const T c[3] = {half_dt, half_dt, dt};
#pragma unroll
  for (int stage = 0; stage < 3; ++stage) {
#pragma unroll
    for (int i = 0; i < 6; ++i) s[i] = add(s0[i], mul(c[stage], k[i]));
#pragma unroll
    for (int d = 0; d < kWidth; ++d)
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        dsum[d][i] = stage == 0 ? dk[d][i] : add(dsum[d][i], mul(T(2), dk[d][i]));
        ds[d][i] = add(seed<T>(i, j0 + d), mul(c[stage], dk[d][i]));
      }
    dynamics_jvp(s, in, ds, du, b, k, dk);
  }

  // row i of the lane's column block: x's tangent + dt / 6 (sum + k4)'
  T* out = j0 < kStates ? A + row * (kStates * kStates) + j0
                        : B + row * (kStates * kInputs) + (j0 - kStates);
  const int ld = j0 < kStates ? kStates : kInputs;
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    Lanes<T> v;
#pragma unroll
    for (int d = 0; d < kWidth; ++d)
      v.v[d] = add(seed<T>(i, j0 + d), mul(sixth_dt, add(dsum[d][i], dk[d][i])));
    *reinterpret_cast<Lanes<T>*>(out + i * ld) = v;
  }
}

template <typename T>
int launch(const T* x, long long x_outer, long long x_row, long long x_col, const T* u,
           long long u_outer, long long u_row, long long u_col, T* A, T* B, long long outer,
           long long inner, Rigid<T> b, T half_dt, T dt, T sixth_dt, void* stream) {
  if (outer < 1 || inner < 1 || outer > LLONG_MAX / inner / kGroup) return cudaErrorInvalidValue;
  const long long rows = outer * inner;
  const long long blocks = (rows * kGroup + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  quadrotor_jac_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, x_outer, x_row, x_col, u, u_outer, u_row, u_col, A, B, inner, rows, b, half_dt, dt,
      sixth_dt);
  return cudaGetLastError();
}

}  // namespace

// The Jacobians of one RK4 step at outer x inner points: point (o, t) of x
// (12 states) at x + o x_outer + t x_row + j x_col, and of u (4 inputs) alike
// (strides in elements, 0 for a broadcast); A (outer inner, 12, 12) and B
// (outer inner, 12, 4) row-major and contiguous, 16-byte aligned, not
// overlapping x or u. All on the card. Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int strided_quadrotor_jac_f32(const float* x, long long x_outer, long long x_row,
                                         long long x_col, const float* u, long long u_outer,
                                         long long u_row, long long u_col, float* A, float* B,
                                         long long outer, long long inner, float inv_m,
                                         float Jx, float Jy, float Jz, float half_dt, float dt,
                                         float sixth_dt, void* stream) {
  return launch<float>(x, x_outer, x_row, x_col, u, u_outer, u_row, u_col, A, B, outer, inner,
                       Rigid<float>{inv_m, Jx, Jy, Jz}, half_dt, dt, sixth_dt, stream);
}

// The same Jacobians in f64.
extern "C" int strided_quadrotor_jac_f64(const double* x, long long x_outer, long long x_row,
                                         long long x_col, const double* u, long long u_outer,
                                         long long u_row, long long u_col, double* A,
                                         double* B, long long outer, long long inner,
                                         double inv_m, double Jx, double Jy, double Jz,
                                         double half_dt, double dt, double sixth_dt,
                                         void* stream) {
  return launch<double>(x, x_outer, x_row, x_col, u, u_outer, u_row, u_col, A, B, outer, inner,
                        Rigid<double>{inv_m, Jx, Jy, Jz}, half_dt, dt, sixth_dt, stream);
}

