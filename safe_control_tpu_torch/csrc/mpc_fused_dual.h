// Forward-mode dual numbers for the fused MPC-CBF kernel (mpc_fused_kernel.cu).
//
// A Dual carries a value and one tangent, d/dU_d for the decision variable
// d that its thread owns.  Each rule is PyTorch's forward-mode formula for
// the operation (the one torch.func.jvp applies in the plain version,
// solvers/mpc_fused.py::solve_fused_batch_reference), written with the same
// operands in the same order, so that a tangent rounds as there:
//
//   a * b        ta * vb + va * tb            a / b   (ta - tb * r) / vb
//   c / a        (-ta * (r * r)) * c          sqrt    t / (2 * r)
//   sin, cos     t * cos v, t * (-sin v)      exp     t * r
//   atan2(y, x)  (-vy * tx + vx * ty) / (vy * vy + vx * vx)
//   abs          t * sgn v                    pow(a, e)  t * (e * pow(v, e - 1))
//   clamp        t where lo <= v <= hi, else 0 (ties pass the tangent)
//   max_tie      t * w, w = 1 where v > c, 0.5 at v == c, else 0 (min_tie alike)
//
// torch.clamp passes the whole tangent at a tie, torch.maximum / minimum
// against a constant tensor pass half of it, as JAX's max / min / clip do.
// A model whose PyTorch module clamps uses dclamp; one whose JAX original
// uses jnp.maximum or jnp.clip, and whose module repeats that with
// torch.maximum / minimum, uses max_tie / min_tie.  Each value propagates a
// NaN as the PyTorch operation does.  The float overloads let one model
// template serve both the value-only rollout and the dual one.
#pragma once

#include <math.h>

namespace mpc_fused {

struct Dual {
  float v, t;
  __device__ Dual() : v(0.0f), t(0.0f) {}
  __device__ Dual(float value) : v(value), t(0.0f) {}
  __device__ Dual(float value, float tangent) : v(value), t(tangent) {}
};

__device__ __forceinline__ float value_of(float a) { return a; }
__device__ __forceinline__ float value_of(const Dual& a) { return a.v; }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) { return Dual(a.v + b.v, a.t + b.t); }
__device__ __forceinline__ Dual operator+(const Dual& a, float c) { return Dual(a.v + c, a.t); }
__device__ __forceinline__ Dual operator+(float c, const Dual& a) { return Dual(c + a.v, a.t); }
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) { return Dual(a.v - b.v, a.t - b.t); }
__device__ __forceinline__ Dual operator-(const Dual& a, float c) { return Dual(a.v - c, a.t); }
__device__ __forceinline__ Dual operator-(float c, const Dual& a) { return Dual(c - a.v, -a.t); }
__device__ __forceinline__ Dual operator-(const Dual& a) { return Dual(-a.v, -a.t); }
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  return Dual(a.v * b.v, a.t * b.v + a.v * b.t);
}
__device__ __forceinline__ Dual operator*(const Dual& a, float c) { return Dual(a.v * c, a.t * c); }
__device__ __forceinline__ Dual operator*(float c, const Dual& a) { return Dual(c * a.v, c * a.t); }
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  const float r = a.v / b.v;
  return Dual(r, (a.t - b.t * r) / b.v);
}
__device__ __forceinline__ Dual operator/(const Dual& a, float c) { return Dual(a.v / c, a.t / c); }

// c / a, as PyTorch evaluates a Python scalar over a tensor: reciprocal(a) * c.
__device__ __forceinline__ float rdiv(float c, float a) { return (1.0f / a) * c; }
__device__ __forceinline__ Dual rdiv(float c, const Dual& a) {
  const float r = 1.0f / a.v;
  return Dual(r * c, (-a.t * (r * r)) * c);
}

__device__ __forceinline__ float dsin(float a) { return sinf(a); }
__device__ __forceinline__ Dual dsin(const Dual& a) { return Dual(sinf(a.v), a.t * cosf(a.v)); }
__device__ __forceinline__ float dcos(float a) { return cosf(a); }
__device__ __forceinline__ Dual dcos(const Dual& a) { return Dual(cosf(a.v), a.t * -sinf(a.v)); }
__device__ __forceinline__ float dexp(float a) { return expf(a); }
__device__ __forceinline__ Dual dexp(const Dual& a) {
  const float r = expf(a.v);
  return Dual(r, a.t * r);
}
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  const float r = sqrtf(a.v);
  return Dual(r, a.t / (2.0f * r));
}
__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual datan2(const Dual& y, const Dual& x) {
  return Dual(atan2f(y.v, x.v), (-y.v * x.t + x.v * y.t) / (y.v * y.v + x.v * x.v));
}

// sign with sign(0) == 0, as torch.sgn on real numbers.
__device__ __forceinline__ float sgn(float x) { return static_cast<float>((x > 0.0f) - (x < 0.0f)); }
__device__ __forceinline__ float dabs(float a) { return fabsf(a); }
__device__ __forceinline__ Dual dabs(const Dual& a) { return Dual(fabsf(a.v), a.t * sgn(a.v)); }

// pow with a constant exponent e >= 2 (the superellipsoid's).
__device__ __forceinline__ float dpow(float a, float e) { return powf(a, e); }
__device__ __forceinline__ Dual dpow(const Dual& a, float e) {
  return Dual(powf(a.v, e), a.t * (e * powf(a.v, e - 1.0f)));
}

// torch.clamp / torch.clamp_min with constant bounds.
__device__ __forceinline__ float dclamp(float a, float lo, float hi) { return fminf(fmaxf(a, lo), hi); }
__device__ __forceinline__ Dual dclamp(const Dual& a, float lo, float hi) {
  const bool inside = (a.v >= lo) && (a.v <= hi);
  return Dual(fminf(fmaxf(a.v, lo), hi), inside ? a.t : 0.0f);
}
__device__ __forceinline__ float dclamp_min(float a, float lo) { return fmaxf(a, lo); }
__device__ __forceinline__ Dual dclamp_min(const Dual& a, float lo) {
  return Dual(fmaxf(a.v, lo), a.v >= lo ? a.t : 0.0f);
}

// torch.maximum / torch.minimum against a constant c: a NaN operand is
// the result, and the tangent is weighted 1, 0.5 (a tie) or 0.
__device__ __forceinline__ float max_tie(float a, float c) { return a != a ? a : fmaxf(a, c); }
__device__ __forceinline__ Dual max_tie(const Dual& a, float c) {
  const float w = a.v == c ? 0.5f : (a.v > c ? 1.0f : 0.0f);
  return Dual(max_tie(a.v, c), a.t * w);
}
__device__ __forceinline__ float min_tie(float a, float c) { return a != a ? a : fminf(a, c); }
__device__ __forceinline__ Dual min_tie(const Dual& a, float c) {
  const float w = a.v == c ? 0.5f : (a.v < c ? 1.0f : 0.0f);
  return Dual(min_tie(a.v, c), a.t * w);
}

// torch.clamp / torch.clamp_min of a value in the solver's own loops: a NaN
// is the result, as in PyTorch (fmaxf / fminf would return the bound).
__device__ __forceinline__ float clamp_nan(float a, float lo, float hi) {
  return a != a ? a : fminf(fmaxf(a, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float a, float lo) { return a != a ? a : fmaxf(a, lo); }

// torch.remainder(a, b) for b > 0: fmod, shifted into [0, b); the tangent
// passes unchanged.
__device__ __forceinline__ float fmod_floor(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r = r + b;
  return r;
}

constexpr float PI_F = (float)3.141592653589793;
constexpr float TWOPI_F = (float)6.283185307179586;

// angle_normalize: remainder(a + pi, 2 pi) - pi.
__device__ __forceinline__ float angle_normalize(float a) {
  return fmod_floor(a + PI_F, TWOPI_F) - PI_F;
}
__device__ __forceinline__ Dual angle_normalize(const Dual& a) {
  return Dual(angle_normalize(a.v), a.t);
}

}  // namespace mpc_fused
