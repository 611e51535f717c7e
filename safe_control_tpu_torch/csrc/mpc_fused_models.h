// The registered models for the fused MPC-CBF kernel (mpc_fused_kernel.cu).
//
// Each model is a struct with its sizes (n, m, REL_DEG), a step template
// over the scalar type T (float, or Dual for the forward-mode columns) and
// its discrete-time barrier dt_h(x, obstacle, mp).  Each template repeats, operation for
// operation, the PyTorch model in safe_control_tpu_torch/dynamics/ that the
// plain version differentiates, so that values and tangents round alike.
// ``mp`` holds the model's constants as solvers/mpc_fused.py::_model_params
// packs them; ``dt`` is the step.
//
// A model ported later adds its struct here, its case to the switch in
// mpc_fused_launch, its packing to _model_params and its id to MODEL_IDS.
#pragma once

#include "mpc_fused_dual.h"

namespace mpc_fused {

// One obstacle, with the values its barrier needs precomputed per problem.
struct Obstacle {
  float ox, oy;
  float circ_off;  // beta * (r + radius)^2
  float ar, br, e;  // superellipsoid: max(|a|,1e-3)+radius, max(|b|,1e-3)+radius, max(|e|,2)
  float ct, st;
  float d_min, vx, vy;  // r + radius, and columns 3, 4 as a moving circle's velocity
  bool circle;
};

// barriers.geometry.h_circle: (dx^2 + dy^2) - beta d_min^2.
template <class T>
__device__ __forceinline__ T h_circle(const T& px, const T& py, const Obstacle& o) {
  const T dx = px - o.ox;
  const T dy = py - o.oy;
  return (dx * dx + dy * dy) - o.circ_off;
}

// barriers.geometry.h_point: circle or superellipsoid by the obstacle flag.
template <class T>
__device__ __forceinline__ T h_point(const T& px, const T& py, const Obstacle& o) {
  if (o.circle) return h_circle(px, py, o);
  const T dx = px - o.ox;
  const T dy = py - o.oy;
  const T qx = o.ct * dx + o.st * dy;
  const T qy = (-o.st) * dx + o.ct * dy;
  return (dpow(dabs(qx) / o.ar, o.e) + dpow(dabs(qy) / o.br, o.e)) - 1.0f;
}

// SingleIntegrator2D: x + u dt.
struct SingleIntegrator2D {
  static constexpr int n = 2, m = 2, REL_DEG = 1;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float*, float dt) {
    for (int i = 0; i < 2; ++i) out[i] = x[i] + u[i] * dt;
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) { return h_point(x[0], x[1], o); }
};

// DoubleIntegrator2D: Euler, then the speed capped at v_max (mp[0]).
struct DoubleIntegrator2D {
  static constexpr int n = 4, m = 2, REL_DEG = 2;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    const float v_max = mp[0];
    out[0] = x[0] + x[2] * dt;
    out[1] = x[1] + x[3] * dt;
    const T v0 = x[2] + u[0] * dt;
    const T v1 = x[3] + u[1] * dt;
    const T v_mag = dsqrt(v0 * v0 + v1 * v1);
    const T scale = value_of(v_mag) > v_max ? rdiv(v_max, dclamp_min(v_mag, 1e-9f)) : T(1.0f);
    out[2] = v0 * scale;
    out[3] = v1 * scale;
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) { return h_point(x[0], x[1], o); }
};

// DynamicUnicycle2D: [x, y, theta, v], Euler with theta wrapped.
struct DynamicUnicycle2D {
  static constexpr int n = 4, m = 2, REL_DEG = 2;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float*, float dt) {
    out[0] = x[0] + (x[3] * dcos(x[2])) * dt;
    out[1] = x[1] + (x[3] * dsin(x[2])) * dt;
    out[2] = angle_normalize(x[2] + u[1] * dt);
    out[3] = x[3] + u[0] * dt;
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) { return h_point(x[0], x[1], o); }
};

// Quad3D: RK4 on A z + B u.  mp[0..15] rows 8..11 of B, mp[16] dt/2, mp[17] dt/6.
struct Quad3D {
  static constexpr int n = 12, m = 4, REL_DEG = 1;
  static constexpr float G = (float)9.8;
  template <class T>
  __device__ static void deriv(const T* z, const T* bu, T* k) {
    for (int i = 0; i < 6; ++i) k[i] = z[6 + i];
    k[6] = G * z[3];
    k[7] = (-G) * z[4];
    for (int i = 0; i < 4; ++i) k[8 + i] = bu[i];
  }
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    T bu[4];
    for (int r = 0; r < 4; ++r) {
      T s = mp[4 * r] * u[0];
      for (int j = 1; j < 4; ++j) s = s + mp[4 * r + j] * u[j];
      bu[r] = s;
    }
    const float h2 = mp[16], h6 = mp[17];
    T k1[12], k2[12], k3[12], k4[12], z[12];
    deriv(x, bu, k1);
    for (int i = 0; i < 12; ++i) z[i] = x[i] + h2 * k1[i];
    deriv(z, bu, k2);
    for (int i = 0; i < 12; ++i) z[i] = x[i] + h2 * k2[i];
    deriv(z, bu, k3);
    for (int i = 0; i < 12; ++i) z[i] = x[i] + dt * k3[i];
    deriv(z, bu, k4);
    for (int i = 0; i < 12; ++i) {
      const T xn = x[i] + h6 * (((k1[i] + 2.0f * k2[i]) + 2.0f * k3[i]) + k4[i]);
      out[i] = (i >= 3 && i < 6) ? angle_normalize(xn) : xn;
    }
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) { return h_circle(x[0], x[1], o); }
};

// VTOL2D: [x, z, theta, vx, vz, w], full 2-D aero, Euler with theta wrapped.
// mp: 0 c_l0, 1 c_lalpha, 2 -m_blend, 3 m_blend, 4 alpha_0, 5-6 c_ldelta_e * (0, 1),
// 7 c_d0, 8 c_dalpha, 9-10 c_ddelta_e * (0, 1), 11 c_m0, 12 c_malpha,
// 13-14 c_mdelta_e * (0, 1), 15 rho_air / 2, 16 s_wing, 17 chord, 18 1/mass,
// 19 1/inertia, 20 mass * g, 21 k_front, 22 k_rear, 23 k_pusher,
// 24 ell_f k_front / inertia, 25 -ell_r k_rear / inertia.
struct VTOL2D {
  static constexpr int n = 6, m = 4, REL_DEG = 2;

  template <class T>
  __device__ static T lift_blending(const T& alpha, const float* mp) {
    const T cl_lin = mp[0] + mp[1] * alpha;
    const T cl_nl = (2.0f * dsin(alpha)) * dcos(alpha);
    const T t1 = dexp(dclamp(mp[2] * (alpha - mp[4]), -40.0f, 40.0f));
    const T t2 = dexp(dclamp(mp[3] * (alpha + mp[4]), -40.0f, 40.0f));
    const T sigma = ((1.0f + t1) + t2) / ((1.0f + t1) * (1.0f + t2));
    return (1.0f - sigma) * cl_lin + sigma * cl_nl;
  }

  // Lift, drag and moment at elevator deflection de (0 or 1).
  template <class T>
  __device__ static void lift_drag_moment(const T& V, const T& alpha, int de, const float* mp,
                                          T& L, T& D, T& Mo) {
    const T cl = lift_blending(alpha, mp) + mp[5 + de];
    const T cd = (mp[7] + mp[8] * (alpha * alpha)) + mp[9 + de];
    const T cm = (mp[11] + mp[12] * alpha) + mp[13 + de];
    const T qs = (mp[15] * (V * V)) * mp[16];
    L = qs * cl;
    D = qs * cd;
    Mo = (qs * cm) * mp[17];
  }

  template <class T>
  __device__ static void wind_to_inertial(const T& theta, const T& alpha, const T& fx_w,
                                          const T& fz_w, T& fx, T& fz) {
    const T h = theta + alpha;
    const T c = dcos(h), s = dsin(h);
    fx = c * fx_w - s * fz_w;
    fz = s * fx_w + c * fz_w;
  }

  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    const T theta = x[2];
    const T c = dcos(theta), s = dsin(theta);
    const T u_b = c * x[3] + s * x[4];
    const T w_b = (-s) * x[3] + c * x[4];
    const T V = dsqrt(u_b * u_b + w_b * w_b);
    const T alpha = datan2(-w_b, u_b);
    const float inv_m = mp[18], inv_i = mp[19];

    // f: the unforced aero plus gravity.
    T L0, D0, M0, fx_a, fz_a;
    lift_drag_moment(V, alpha, 0, mp, L0, D0, M0);
    wind_to_inertial(theta, alpha, -D0, L0, fx_a, fz_a);
    const T f[6] = {x[3], x[4], x[5], fx_a * inv_m, (fz_a - mp[20]) * inv_m, M0 * inv_i};

    // g: the rotor partials and the elevator's delta_e = 1 increment.
    T L1, D1, M1, fx_e, fz_e;
    lift_drag_moment(V, alpha, 1, mp, L1, D1, M1);
    wind_to_inertial(theta, alpha, -D1, L1, fx_e, fz_e);
    const T ms = -s;
    const T g[6][4] = {
        {T(0.0f), T(0.0f), T(0.0f), T(0.0f)},
        {T(0.0f), T(0.0f), T(0.0f), T(0.0f)},
        {T(0.0f), T(0.0f), T(0.0f), T(0.0f)},
        {(ms * mp[21]) * inv_m, (ms * mp[22]) * inv_m, (c * mp[23]) * inv_m, fx_e * inv_m},
        {(c * mp[21]) * inv_m, (c * mp[22]) * inv_m, (s * mp[23]) * inv_m, fz_e * inv_m},
        {T(mp[24]), T(mp[25]), T(0.0f), M1 * inv_i},
    };
    for (int i = 0; i < 6; ++i) {
      T gu = g[i][0] * u[0];
      for (int j = 1; j < 4; ++j) gu = gu + g[i][j] * u[j];
      const T xn = x[i] + (f[i] + gu) * dt;
      out[i] = i == 2 ? angle_normalize(xn) : xn;
    }
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) { return h_circle(x[0], x[1], o); }
};

// Unicycle2D: [x, y, theta], u = [v, omega], Euler with theta wrapped; the
// discrete barrier is the plain circle whatever the obstacle's flag.
struct Unicycle2D {
  static constexpr int n = 3, m = 2, REL_DEG = 1;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float*, float dt) {
    out[0] = x[0] + (dcos(x[2]) * u[0]) * dt;
    out[1] = x[1] + (dsin(x[2]) * u[0]) * dt;
    out[2] = angle_normalize(x[2] + u[1] * dt);
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    return h_circle(x[0], x[1], o);
  }
};

// KinematicBicycle2D: [x, y, theta, v], u = [a, beta], Euler with theta
// wrapped and v clipped to [v_min, v_max] (half the tangent at a tie).
// mp: 0 1 / rear_ax_dist, 1 v_min, 2 v_max.
struct KinematicBicycle2D {
  static constexpr int n = 4, m = 2, REL_DEG = 2;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    const T c = dcos(x[2]), s = dsin(x[2]);
    const T& v = x[3];
    out[0] = x[0] + (v * c + ((-v) * s) * u[1]) * dt;
    out[1] = x[1] + (v * s + (v * c) * u[1]) * dt;
    out[2] = angle_normalize(x[2] + ((v * mp[0]) * u[1]) * dt);
    out[3] = min_tie(max_tie(v + u[0] * dt, mp[1]), mp[2]);
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    return h_point(x[0], x[1], o);
  }
};

// The obstacle's position and velocity relative to a bicycle robot.
template <class T>
__device__ __forceinline__ void relative_motion(const T* x, const Obstacle& o, T& px, T& py,
                                                T& vx, T& vy) {
  px = o.ox - x[0];
  py = o.oy - x[1];
  vx = o.vx - x[3] * dcos(x[2]);
  vy = o.vy - x[3] * dsin(x[2]);
}

// The collision-cone barrier (C3BF) at the discrete margin beta = 1.01.
struct KinematicBicycle2D_C3BF : KinematicBicycle2D {
  static constexpr int REL_DEG = 1;
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    const float eps = (float)1e-6;
    const float ego = o.d_min * (float)1.01;
    T px, py, vx, vy;
    relative_motion(x, o, px, py, vx, vy);
    const T p_mag = dsqrt(px * px + py * py);
    const T v_mag = dsqrt(vx * vx + vy * vy);
    const T sqrt_term = dsqrt(max_tie(p_mag * p_mag - ego * ego, eps));
    const T cos_phi = sqrt_term / (p_mag + eps);
    return (px * vx + py * vy) + (p_mag * v_mag) * cos_phi;
  }
};

// The dynamic parabolic barrier (DPCBF), s = 1.05.  mp[3]: sqrt(s^2 - 1).
struct KinematicBicycle2D_DPCBF : KinematicBicycle2D {
  static constexpr int REL_DEG = 1;
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float* mp) {
    const float eps = (float)1e-6;
    const float ego = o.d_min * (float)1.05;
    T px, py, vx, vy;
    relative_motion(x, o, px, py, vx, vy);
    const T p_mag = dsqrt(px * px + py * py);
    const T v_mag = dsqrt(vx * vx + vy * vy);
    const T rot = datan2(py, px);
    const T c = dcos(rot), sn = dsin(rot);
    const T v_rel_x = c * vx + sn * vy;
    const T v_rel_y = (-sn) * vx + c * vy;
    const T d_safe = max_tie(p_mag * p_mag - ego * ego, eps);
    const float scale = rdiv(mp[3], ego);
    const T lam = (((float)0.1 * dsqrt(d_safe)) / max_tie(v_mag, eps)) * scale;
    const T mu = (0.5f * dsqrt(d_safe)) * scale;
    return (v_rel_x + lam * (v_rel_y * v_rel_y)) + mu;
  }
};

// Quad2D: [x, z, theta, vx, vz, w], u = [F_r, F_l], Euler with theta wrapped.
// mp: 0 1 / mass, 1 radius / inertia.
struct Quad2D {
  static constexpr int n = 6, m = 2, REL_DEG = 2;
  static constexpr float G = (float)9.81;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    const T gs = (-dsin(x[2])) * mp[0];
    const T gc = dcos(x[2]) * mp[0];
    const float k = mp[1];
    out[0] = x[0] + x[3] * dt;
    out[1] = x[1] + x[4] * dt;
    out[2] = angle_normalize(x[2] + x[5] * dt);
    out[3] = x[3] + (gs * u[0] + gs * u[1]) * dt;
    out[4] = x[4] + ((gc * u[0] + gc * u[1]) + (-G)) * dt;
    out[5] = x[5] + (k * u[0] + (-k) * u[1]) * dt;
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    return h_point(x[0], x[1], o);
  }
};

// Manipulator2D: joint angles, u = joint rates, q + u dt.  Its MPC barrier
// acts on barrier_pos(q) = 0 q[:2], a constant, as the JAX package's does.
struct Manipulator2D {
  static constexpr int n = 3, m = 3, REL_DEG = 1;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float*, float dt) {
    for (int i = 0; i < 3; ++i) out[i] = x[i] + u[i] * dt;
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    return h_point(x[0] * 0.0f, x[1] * 0.0f, o);
  }
};

// The Fiala lateral force of one axle: the linear (brush) branch where
// |alpha| < alpha_sl, else the saturated one, chosen on the values (the
// tangent is the chosen branch's).  ``Fx`` is the axle's drive force: the
// float 0 at the front (no tangent, as a zeros tensor), a T at the rear.
// c: -Cc, Cc^2, Cc^3, 1/Cc, (mu Fz)^2; gamma the friction-circle factor.
template <class T, class F>
__device__ __forceinline__ T fiala_force(const T& alpha, const float* c, float gamma, const F& Fx) {
  const F Fy_max = dsqrt(max_tie(c[4] - gamma * (Fx * Fx), 1.0f));
  const F alpha_sl = datan((3.0f * Fy_max) * c[3]);
  const T tan_a = dtan(alpha);
  const T lin = (c[0] * tan_a + (rdiv(c[1], 3.0f * Fy_max) * dabs(tan_a)) * tan_a) -
                rdiv(c[2], 27.0f * (Fy_max * Fy_max)) * ((tan_a * tan_a) * tan_a);
  const T sat = (-Fy_max) * dsign(alpha);
  return select(fabsf(value_of(alpha)) < value_of(alpha_sl), lin, sat);
}

// DynamicBicycle2D: [r, beta, V, delta, tau], u = [delta_dot, tau_dot]; the
// Fiala tyres, Euler, then the 5-way state clamp (half the tangent at a
// tie).  Its MPC barrier acts on barrier_pos(x) = 0 x[:2], a constant.
// mp: 0 a_cg, 1 b_cg, 2 1/izz, 3 mass, 4 1/mass, 5-9 the front axle's
// fiala_force constants, 10-14 the rear's, 15 gamma_stab, 16 mu Fz_r,
// 17 1/(r_w max(mu Fz_r, 1)), 18-27 the clamp's (lower, upper) pairs.
struct DynamicBicycle2D {
  static constexpr int n = 5, m = 2, REL_DEG = 2;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    const T &r = x[0], &beta = x[1], &V = x[2], &delta = x[3], &tau = x[4];
    const T V_safe = max_tie(V, (float)0.1);
    const T cb = dcos(beta), sb = dsin(beta);
    const T alpha_f = datan2(V * sb + mp[0] * r, V_safe * cb) - delta;
    const T alpha_r = datan2(V * sb - mp[1] * r, V_safe * cb);
    const float Fx_f = 0.0f;
    const T Fx_r = mp[16] * dtanh(tau * mp[17]);
    const T Fy_f = fiala_force(alpha_f, mp + 5, mp[15], Fx_f);
    const T Fy_r = fiala_force(alpha_r, mp + 10, mp[15], Fx_r);
    const T sd = dsin(delta), cd = dcos(delta);
    const T db = delta - beta;
    const T sdb = dsin(db), cdb = dcos(db);
    const T r_dot = (mp[0] * (Fx_f * sd + Fy_f * cd) - mp[1] * Fy_r) * mp[2];
    const T beta_dot = (((Fx_f * sdb + Fy_f * cdb) - Fx_r * sb) + Fy_r * cb) / (mp[3] * V_safe) - r;
    const T V_dot = (((Fx_f * cdb - Fy_f * sdb) + Fx_r * cb) + Fy_r * sb) * mp[4];
    const T next[5] = {r + r_dot * dt, beta + beta_dot * dt, V + V_dot * dt, delta + u[0] * dt,
                       tau + u[1] * dt};
    for (int i = 0; i < 5; ++i) out[i] = min_tie(max_tie(next[i], mp[18 + 2 * i]), mp[19 + 2 * i]);
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    return h_point(x[0] * 0.0f, x[1] * 0.0f, o);
  }
};

// DriftingCar: [x, y, theta] + the DynamicBicycle2D state.  The body steps
// first; the pose then moves with the NEXT (V, beta, r) and the CURRENT
// theta, theta wrapped.  mp: DynamicBicycle2D's.
struct DriftingCar {
  static constexpr int n = 8, m = 2, REL_DEG = 1;
  template <class T>
  __device__ static void step(const T* x, const T* u, T* out, const float* mp, float dt) {
    T body[5];
    DynamicBicycle2D::step(x + 3, u, body, mp, dt);
    const T h = x[2] + body[1];
    out[0] = x[0] + (body[2] * dcos(h)) * dt;
    out[1] = x[1] + (body[2] * dsin(h)) * dt;
    out[2] = angle_normalize(x[2] + body[0] * dt);
    for (int i = 0; i < 5; ++i) out[3 + i] = body[i];
  }
  template <class T>
  __device__ static T dt_h(const T* x, const Obstacle& o, const float*) {
    return h_point(x[0], x[1], o);
  }
};

}  // namespace mpc_fused
