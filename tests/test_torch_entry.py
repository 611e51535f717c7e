"""The port's main path against the JAX one, and ``chip_smoke.py`` without a card.

``entry.build_step(batch=8, device="cpu")`` against
``__graft_entry__._build_step(batch=8)``: identical input arrays, then three
chained control steps, each side fed the same inputs (the JAX step's
outputs) at every step; u, U and x_next must agree to 5e-3, the float32
kernel-class envelope.  On the CPU the port's step runs the fused kernel's
plain PyTorch version through ``mpc_cbf.solve_batch``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_step
from safe_control_tpu_torch import entry
from safe_control_tpu_torch.solvers import mpc_du_kernel as duk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("use_fused_kernel", [True, False])
def test_build_step_matches_jax_build_step(use_fused_kernel):
    jstep, jargs = _build_step(batch=8)
    tstep, targs = entry.build_step(8, device="cpu", use_fused_kernel=use_fused_kernel)
    jargs = [np.asarray(a) for a in jargs]
    for got, want in zip(targs, jargs):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    jfn = jax.jit(jstep)
    xs, goals, obs, u_prevs, Us = jargs
    before = duk.LAUNCH_COUNT
    for _ in range(3):
        want = [np.asarray(a) for a in jfn(xs, goals, obs, u_prevs, Us)]
        got = tstep(*(torch.tensor(a) for a in (xs, goals, obs, u_prevs, Us)))
        for name, g, w in zip(("x_next", "u", "U"), got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-3, err_msg=name)
        xs, u_prevs, Us = want
    assert duk.LAUNCH_COUNT == before  # no kernel launch on the CPU


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
