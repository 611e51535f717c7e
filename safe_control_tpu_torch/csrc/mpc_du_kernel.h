// Constants of the fused DU N=8 MPC-CBF kernel (mpc_du_kernel.cu).
//
// They mirror the module constants of
// safe_control_tpu_torch/solvers/mpc_du_kernel.py; a CPU test parses this
// header and checks every value against the Python module.  Values that
// Python computes in double and the kernel uses as float are written as the
// same double expression cast to float, so both round identically.
#pragma once

namespace mpc_du {

constexpr int N = 8;               // horizon
constexpr int K = 5;               // obstacle slots
constexpr int M = 16;              // decision variables, 2 * N
constexpr int NR = 48;             // residual rows: state (8x4) + input moves (8x2)
constexpr int NC = 56;             // constraint rows: CBF (8x5) + v bounds (8x2)
constexpr int OBS_DIM = 7;

// Launch shape: one group of LANES lanes (a half-warp) per problem, lane j
// owning decision variable j; THREADS-thread blocks of PROBLEMS_PER_BLOCK
// problems.
constexpr int LANES = 16;          // lanes per problem, = M
constexpr int THREADS = 128;       // threads per block
constexpr int PROBLEMS_PER_BLOCK = THREADS / LANES;

// Default MPCConfig budget.
constexpr int OUTER = 8;
constexpr int NEWTON = 3;
constexpr float RHO0 = (float)50.0;
constexpr float RHO_GROWTH = (float)1.6;
constexpr float RHO_MAX = (float)2000.0;
constexpr float REG = (float)1e-6;
constexpr int NUM_ALPHAS = 6;          // line-search step lengths
constexpr float ALPHA_0 = (float)1.0;
constexpr float ALPHA_1 = (float)0.5;
constexpr float ALPHA_2 = (float)0.25;
constexpr float ALPHA_3 = (float)0.1;
constexpr float ALPHA_4 = (float)0.03;
constexpr float ALPHA_5 = (float)0.0;
constexpr float NOISE_EPS = (float)(4.0 * 1.1920929e-7);  // 4 * eps_f32

// sqrt of the DU cost weights: Q = (50, 50, 0.01, 30), R = (0.5, 0.5).
constexpr float SQ_0 = (float)7.0710678118654755;
constexpr float SQ_1 = (float)7.0710678118654755;
constexpr float SQ_2 = (float)0.1;
constexpr float SQ_3 = (float)5.477225575051661;
constexpr float SR_0 = (float)0.7071067811865476;
constexpr float SR_1 = (float)0.7071067811865476;

// Constant 2 Jr_in' Jr_in of the input-move rows, rounded to float:
// 2*SR^2*2 on the diagonal of stages 0..6, 2*SR^2 on the last stage's,
// -2*SR^2 between one input at neighbouring stages, zero elsewhere.
constexpr float IH_DIAG = (float)2.0;
constexpr float IH_DIAG_LAST = (float)1.0;
constexpr float IH_OFF = (float)-1.0;

constexpr float PI_F = (float)3.141592653589793;
constexpr float TWOPI_F = (float)6.283185307179586;

}  // namespace mpc_du
