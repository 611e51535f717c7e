"""safe_control_tpu_torch — the PyTorch/CUDA port of safe_control_tpu.

The JAX package ``safe_control_tpu`` is the reference; this package mirrors
its layout module by module (``core/``, ``dynamics/``, ``barriers/``,
``solvers/``, ``perception/``, ``attitude/``, ``sim/``, ``shielding/``,
``envs/``, ``parallel/``, ``utils/``) so each port sits at the same relative
path as its original.
It imports ``torch`` and ``numpy`` only.  Functions take batched tensors
with a leading batch axis, create tensors on an explicit ``device=`` and
keep no global device state.

Ported so far: the DynamicUnicycle2D MPC-CBF main path (``entry.build_step``),
the CBF-QP filter and the generic fused MPC-CBF solve, with three
hand-written CUDA kernels (``solvers/mpc_du_kernel.py``,
``solvers/qp_kernel.py``, ``solvers/mpc_fused.py``; sources in ``csrc/``),
the tracking loop batched over robots (``sim/tracking.py``,
``sim/controller.py``), all 13 models, MPCC and the shielded drift-car
simulator (``sim/drift_sim.py``), the warehouse case study
(``sim/warehouse_sim.py``), heterogeneous and shielded fleets
(``parallel/fleet.py``), and the Monte Carlo sweep, on one device or split
over a ``torch.distributed`` process group (``parallel/monte_carlo.py``,
``parallel/mesh.py``).
"""
