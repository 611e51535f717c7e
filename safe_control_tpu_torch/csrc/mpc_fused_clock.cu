// The generic fused MPC-CBF kernel's instantiations with the phase clock
// (mpc_fused_kernel.cu, "Phase clock"), as a library of their own, so that
// the plain library's code is the solve alone.  The same C entry points;
// mpc_fused_launch takes the clock's buffer.
#define MPC_FUSED_CLOCK 1
#include "mpc_fused_kernel.cu"
