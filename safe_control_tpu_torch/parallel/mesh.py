"""The scenario mesh of the multi-device sweep: waits for ROADMAP A.7.

The JAX package shards the scenario batch over a device mesh
(``safe_control_tpu/parallel/mesh.py``); its port becomes
``torch.distributed`` collectives in A.7.  Until then these raise.
"""

from __future__ import annotations

SCENARIO_AXIS = "scenario"


def scenario_mesh(n_devices=None):
    raise NotImplementedError("the scenario mesh is not ported yet (ROADMAP A.7)")
