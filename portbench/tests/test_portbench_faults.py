"""A run whose timed path is broken underneath comes out not correct: the
harness's loop and check on the CPU at a tiny size, with the look for a
card skipped, once for each fault a cell can have.  (No cell spans chips,
so none can leave out an exchange between them.)  And the control, the
answers in bfloat16, fails the limits that the program's answers meet."""

import math

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import TINY
from safe_control_tpu_torch.sim import tracking
from safe_control_tpu_torch.solvers import cbf_qp, mpc_cbf

SEED = 2**31 + 41


def state_unchanged(monkeypatch):
    """The tracking step returns the state it was given."""
    step = tracking.step
    monkeypatch.setattr(tracking, "step",
                        lambda cfg, spec, state, *a: step(cfg, spec, state, *a)._replace(
                            state=state))


def half_batch(monkeypatch):
    """The second half of the batch left out: its inputs the mean of the
    first half's, its states not advanced."""
    step = tracking.step

    def broken(cfg, spec, state, *a):
        out = step(cfg, spec, state, *a)
        h = state.x.shape[0] // 2
        u = torch.cat([out.u[:h], out.u[:h].mean(0, keepdim=True).expand_as(out.u[h:])])
        x = torch.cat([out.state.x[:h], state.x[h:]])
        return out._replace(u=u, state=out.state._replace(x=x, u_prev=u))

    monkeypatch.setattr(tracking, "step", broken)


def answer_altered(monkeypatch):
    """The first robot's input altered by 0.05 where the solver makes it."""

    def altered(fn):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            u = res.u.clone()
            u[0, 0] += 0.05
            return res._replace(u=u)
        return wrapped

    monkeypatch.setattr(mpc_cbf, "solve_dispatch", altered(mpc_cbf.solve_dispatch))
    monkeypatch.setattr(cbf_qp, "solve_batch", altered(cbf_qp.solve_batch))


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
CASES = [(cell, fault) for cell in TINY for fault in FAULTS
         if not (fault == "half_batch" and cell == "du_single.ctrl")]  # a batch of one


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = harness.run_cell(cell, SEED, 0.0, trace=False, device="cpu", overrides=TINY[cell],
                         log=lambda *_: None, bench=harness.load_benchmark(held_back=True))
    assert not r["correct"]
    failed = [k for k, c in r["checks"].items()
              if not (isinstance(c["value"], float) and c["value"] <= c["limit"])]
    assert failed


@pytest.mark.parametrize("cell", list(TINY))
def test_control_fails_the_limits_the_program_meets(cell):
    limits = harness.resolve(harness.load_benchmark(held_back=True), cell)["limits"]["limits"]
    program, low, finite = control.readings(cell, SEED, 0.0, device="cpu",
                                            overrides=TINY[cell], held_back=True)
    assert harness.check_limits(program, limits)[0], program
    assert not harness.check_limits(low, limits)[0], low
    assert all(math.isfinite(v) for v in finite.values())
