"""safe_control_tpu_torch — the PyTorch/CUDA port of safe_control_tpu.

The JAX package ``safe_control_tpu`` is the reference; this package mirrors
its layout module by module (``core/``, ``dynamics/``, ``barriers/``,
``solvers/``) so each port sits at the same relative path as its original.
It imports ``torch`` and ``numpy`` only.  Functions take batched tensors
with a leading batch axis, create tensors on an explicit ``device=`` and
keep no global device state.

Ported so far: the DynamicUnicycle2D MPC-CBF main path (``entry.build_step``),
with the fused DU N=8 solve as a hand-written CUDA kernel
(``solvers/mpc_du_kernel.py``, sources in ``csrc/``).
"""
