// One step of the three-term Wigner-d recurrence (paper Eq. 2),
//
//   d_{l+1} = A (cos b - mu) d_l - C d_{l-1},
//
// the device counterpart of `_recurrence_step` in
// repro/kernels/wigner_rec.py and of its torch twin
// repro_torch/kernels/wigner_rec.py:recurrence_step.  Every kernel that
// marches the recurrence (the fused DWT/iDWT now, the l-chunked streaming
// kernels and their window builder later) calls these two functions, so
// they all compute each step bit for bit alike.
//
// Contraction policy: every multiply, add, divide and square root below
// is an explicitly rounded intrinsic (__dmul_rn, __dsub_rn, ...), which
// nvcc never fuses into an FMA, whatever -fmad says.  The step therefore
// rounds like torch's elementwise ops, and a chunked march that resumes
// from a stored (d_{l-1}, d_l) window equals the monolithic march bitwise.
#pragma once

#include <cuda_runtime.h>

namespace repro {

template <typename T> struct Rn;

template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

// The per-(cluster, degree) coefficients of one step; independent of j.
template <typename T> struct WignerCoeffs {
  T A, mu, C;
};

// Coefficients for degree l of the pair (m, m'):
//   den = 1 / sqrt(max(((l+1)^2 - m^2) ((l+1)^2 - m'^2), 1))
//   A   = (l+1)(2l+1) den
//   mu  = m m' / (l (l+1))                              (0 at l = 0)
//   C   = (l+1) sqrt(max((l^2 - m^2)(l^2 - m'^2), 0)) den / l   (0 at l = 0)
// The clamp keeps rows with l < max(m, m') finite; they are masked.
template <typename T>
__device__ __forceinline__ WignerCoeffs<T> wigner_coeffs(int l, int m, int mp) {
  using R = Rn<T>;
  const T lf = T(l), mf = T(m), mpf = T(mp);
  const T lp1 = R::add(lf, T(1));
  const T lp1sq = R::mul(lp1, lp1);
  const T x = R::mul(R::sub(lp1sq, R::mul(mf, mf)), R::sub(lp1sq, R::mul(mpf, mpf)));
  const T den = R::div(T(1), R::sqrt(x > T(1) ? x : T(1)));
  WignerCoeffs<T> c;
  c.A = R::mul(R::mul(lp1, R::add(R::mul(T(2), lf), T(1))), den);
  if (l > 0) {
    const T lsq = R::mul(lf, lf);
    const T y = R::mul(R::sub(lsq, R::mul(mf, mf)), R::sub(lsq, R::mul(mpf, mpf)));
    c.mu = R::div(R::mul(mf, mpf), R::mul(lf, lp1));
    c.C = R::div(R::mul(R::mul(lp1, R::sqrt(y > T(0) ? y : T(0))), den), lf);
  } else {
    c.mu = T(0);
    c.C = T(0);
  }
  return c;
}

// One step at degree l for one (cluster, j) entry.  Seeds the state at
// l == m, returns the row value d_l (zero while l < m), and advances
// (d_prev, d_cur) to degree l+1, holding them at zero while inactive.
template <typename T>
__device__ __forceinline__ T wigner_step(const WignerCoeffs<T>& c, int l, int m,
                                         T cb, T seed, T& d_prev, T& d_cur) {
  using R = Rn<T>;
  if (l == m) d_cur = seed;
  const bool active = m <= l;
  const T row = active ? d_cur : T(0);
  const T d_next = R::sub(R::mul(R::mul(c.A, R::sub(cb, c.mu)), d_cur),
                          R::mul(c.C, d_prev));
  d_prev = active ? d_cur : T(0);
  d_cur = active ? d_next : T(0);
  return row;
}

}  // namespace repro
