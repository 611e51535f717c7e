"""Dynamics model registry: the JAX package's 13 models.

``get_model`` raises a ``ValueError`` for a name it does not know.  Every
registered model also has a CUDA instantiation of the fused MPC kernel
(``csrc/mpc_fused_models.h``).
"""

from safe_control_tpu_torch.core import spec as _spec
from safe_control_tpu_torch.dynamics import base
from safe_control_tpu_torch.dynamics import double_integrator2d
from safe_control_tpu_torch.dynamics import drifting_car
from safe_control_tpu_torch.dynamics import dynamic_bicycle2d
from safe_control_tpu_torch.dynamics import dynamic_unicycle2d
from safe_control_tpu_torch.dynamics import kinematic_bicycle2d
from safe_control_tpu_torch.dynamics import kinematic_bicycle2d_c3bf
from safe_control_tpu_torch.dynamics import kinematic_bicycle2d_dpcbf
from safe_control_tpu_torch.dynamics import manipulator2d
from safe_control_tpu_torch.dynamics import quad2d
from safe_control_tpu_torch.dynamics import quad3d
from safe_control_tpu_torch.dynamics import single_integrator2d
from safe_control_tpu_torch.dynamics import unicycle2d
from safe_control_tpu_torch.dynamics import vtol2d

base.register(_spec.SINGLE_INTEGRATOR_2D, single_integrator2d)
base.register(_spec.DOUBLE_INTEGRATOR_2D, double_integrator2d)
base.register(_spec.UNICYCLE_2D, unicycle2d)
base.register(_spec.DYNAMIC_UNICYCLE_2D, dynamic_unicycle2d)
base.register(_spec.KINEMATIC_BICYCLE_2D, kinematic_bicycle2d)
base.register(_spec.KINEMATIC_BICYCLE_2D_C3BF, kinematic_bicycle2d_c3bf)
base.register(_spec.KINEMATIC_BICYCLE_2D_DPCBF, kinematic_bicycle2d_dpcbf)
base.register(_spec.QUAD_2D, quad2d)
base.register(_spec.QUAD_3D, quad3d)
base.register(_spec.VTOL_2D, vtol2d)
base.register(_spec.MANIPULATOR_2D, manipulator2d)
base.register(_spec.DYNAMIC_BICYCLE_2D, dynamic_bicycle2d)
base.register(_spec.DRIFTING_CAR, drifting_car)

get_model = base.get_model
MODEL_REGISTRY = base.MODEL_REGISTRY

__all__ = ["get_model", "MODEL_REGISTRY", "base"]
