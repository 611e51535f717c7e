"""Dynamics model registry.

Ported so far: SingleIntegrator2D, DoubleIntegrator2D, DynamicUnicycle2D,
Quad3D and VTOL2D; ``get_model`` raises a ``ValueError`` naming any other
model as not yet ported.  Every registered model also has a CUDA
instantiation of the fused MPC kernel (``csrc/mpc_fused_models.h``).
"""

from safe_control_tpu_torch.core import spec as _spec
from safe_control_tpu_torch.dynamics import base
from safe_control_tpu_torch.dynamics import double_integrator2d
from safe_control_tpu_torch.dynamics import dynamic_unicycle2d
from safe_control_tpu_torch.dynamics import quad3d
from safe_control_tpu_torch.dynamics import single_integrator2d
from safe_control_tpu_torch.dynamics import vtol2d

base.register(_spec.SINGLE_INTEGRATOR_2D, single_integrator2d)
base.register(_spec.DOUBLE_INTEGRATOR_2D, double_integrator2d)
base.register(_spec.DYNAMIC_UNICYCLE_2D, dynamic_unicycle2d)
base.register(_spec.QUAD_3D, quad3d)
base.register(_spec.VTOL_2D, vtol2d)

get_model = base.get_model
MODEL_REGISTRY = base.MODEL_REGISTRY

__all__ = ["get_model", "MODEL_REGISTRY", "base"]
