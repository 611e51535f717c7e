"""Gatekeeper / MPS shielding: infinite-time safety by committed trajectories.

Port of ``safe_control_tpu/shielding/gatekeeper.py``, batched over a leading
robot axis B.  The committed trajectory is a nominal prefix and a backup
suffix.  At an event every candidate switch point is evaluated at once: one
nominal rollout (or an external MPC trajectory), the backup rollouts from
every candidate switch state batched on a candidate axis, per-step
collision flags, prefix-AND masks, and the longest valid candidate as the
first of a boolean argmax.  If none validates the previous commitment is
kept (with ``revalidate``, its remaining suffix is re-checked and a failed
one falls to an immediate backup commitment).  MPS is the same machinery
with one 1-step nominal candidate re-evaluated every step (``mps_mode``).

The environment enters through ``collision_fn(states, offsets) -> bool``:
``states (B, ..., n)``, ``offsets`` an integer tensor of step offsets from
now that broadcasts against ``states.shape[:-1]``; the result has that
shape.  Policies map ``(..., n)`` states to ``(..., m)`` inputs.  Nothing is
read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from safe_control_tpu_torch.core.types import device_constant, first_true, take_rows
from safe_control_tpu_torch.dynamics import get_model


@dataclasses.dataclass(frozen=True)
class GatekeeperConfig:
    """The JAX package's fields and defaults.  ``revalidate`` re-checks the
    remaining committed suffix at an event where no candidate validates."""

    model_name: str
    dt: float = 0.05
    nominal_steps: int = 40  # max nominal horizon (steps)
    backup_steps: int = 40  # backup horizon (steps)
    event_offset_steps: int = 10
    discount_steps: int = 5  # backward-search granularity
    mps_mode: bool = False  # MPS: a single 1-step candidate, an event every step
    revalidate: bool = False

    @property
    def num_candidates(self) -> int:
        if self.mps_mode:
            return 1
        return self.nominal_steps // self.discount_steps + 2

    @property
    def committed_len(self) -> int:
        return self.nominal_steps + self.backup_steps + 1

    def candidate_lengths(self) -> list:
        """Nominal prefix lengths tried, longest first: N_N, N_N - d, ..., 0
        (MPS: ``[min(1, N_N)]``)."""
        if self.mps_mode:
            return [min(1, self.nominal_steps)]
        return [max(self.nominal_steps - i * self.discount_steps, 0)
                for i in range(self.num_candidates)]


class GatekeeperState(NamedTuple):
    committed_x: torch.Tensor  # (B, L, n)
    committed_u: torch.Tensor  # (B, L-1, m)
    committed_valid: torch.Tensor  # (B, L-1) bool: u rows that exist
    time_idx: torch.Tensor  # (B,) int64, index into the committed arrays
    next_event_idx: torch.Tensor  # (B,) int64
    nominal_steps_committed: torch.Tensor  # (B,) int64
    initialized: torch.Tensor  # (B,) bool


class GatekeeperOutput(NamedTuple):
    u: torch.Tensor  # (B, m)
    state: GatekeeperState
    using_backup: torch.Tensor  # (B,) bool: past the committed nominal prefix
    event_fired: torch.Tensor
    candidate_found: torch.Tensor


def init_state(cfg: GatekeeperConfig, batch: int = 1, *, device=None,
               dtype=torch.float32) -> GatekeeperState:
    model = get_model(cfg.model_name)
    L = cfg.committed_len
    zero = torch.zeros((batch,), dtype=torch.long, device=device)
    return GatekeeperState(
        committed_x=torch.zeros((batch, L, model.N_STATES), dtype=dtype, device=device),
        committed_u=torch.zeros((batch, L - 1, model.N_CONTROLS), dtype=dtype, device=device),
        committed_valid=torch.zeros((batch, L - 1), dtype=torch.bool, device=device),
        time_idx=zero, next_event_idx=zero.clone(), nominal_steps_committed=zero.clone(),
        initialized=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def rollout(model, spec, dt, policy, x0, n_steps: int):
    """Closed-loop rollout from ``x0 (..., n)``: ``xs (..., n_steps+1, n)``
    and ``us (..., n_steps, m)``."""
    xs, us = [x0], []
    x = x0
    for _ in range(n_steps):
        u = policy(x)
        x = model.step(x, u, spec, dt)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def _gather_rows(a, idx):
    """``a[b, idx[b, j]]`` for ``a (B, R, d)`` and ``idx (B, J)``."""
    return torch.gather(a, 1, idx[..., None].expand(idx.shape + a.shape[-1:]))


def _where(mask, a, b):
    """``torch.where`` with ``mask (B,)`` over the trailing axes of a and b."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def step(cfg: GatekeeperConfig, spec, state: GatekeeperState, x, backup_policy: Callable,
         collision_fn: Callable, nominal_policy: Optional[Callable] = None,
         nominal_traj: Optional[tuple] = None,
         terminal_fn: Optional[Callable] = None) -> GatekeeperOutput:
    """One gatekeeper step for B robots at ``x (B, n)``.

    Exactly one of ``nominal_policy`` (a closed-loop law) or
    ``nominal_traj`` (states ``(B, N_N+1, n)`` and inputs ``(B, N_N, m)``
    from an external MPC) must be given.  ``terminal_fn(states) -> bool``
    (optional) is the invariant-set test on the end state of a backup
    rollout: a candidate is valid only if its backup reaches the set.
    """
    model = get_model(cfg.model_name)
    dt = cfg.dt
    N_N, N_B, L = cfg.nominal_steps, cfg.backup_steps, cfg.committed_len
    B, m = x.shape[0], model.N_CONTROLS
    dev = x.device

    if nominal_traj is not None:
        nom_x, nom_u = nominal_traj
        if nom_x.shape[1] != N_N + 1:
            raise ValueError("the external nominal trajectory must match cfg.nominal_steps")
    elif nominal_policy is not None:
        nom_x, nom_u = rollout(model, spec, dt, nominal_policy, x, N_N)
    else:
        raise ValueError("need nominal_policy or nominal_traj")

    # The backup from now (the first commitment, and the stale fallback) and
    # from every candidate switch state, in one batched rollout.
    cand_lens = cfg.candidate_lengths()
    lens = device_constant(cand_lens, dtype=torch.long, device=dev)
    starts = torch.cat([x[:, None], nom_x[:, lens]], dim=1)  # (B, 1 + C, n)
    bx_all, bu_all = rollout(model, spec, dt, backup_policy, starts, N_B)
    init_bx, init_bu = bx_all[:, 0], bu_all[:, 0]
    cand_bx, cand_bu = bx_all[:, 1:], bu_all[:, 1:]

    # Initialization: commit the pure backup.
    init_cx = torch.cat([init_bx, init_bx[:, -1:].expand(B, L - (N_B + 1), -1)], dim=1)
    init_cu = torch.cat([init_bu, init_bu.new_zeros((B, L - 1 - N_B, m))], dim=1)
    init_cv = (torch.arange(L - 1, device=dev) < N_B).expand(B, L - 1)
    fresh = ~state.initialized
    zero = torch.zeros_like(state.time_idx)
    state = GatekeeperState(
        committed_x=_where(fresh, init_cx, state.committed_x),
        committed_u=_where(fresh, init_cu, state.committed_u),
        committed_valid=_where(fresh, init_cv, state.committed_valid),
        time_idx=torch.where(fresh, zero, state.time_idx),
        next_event_idx=torch.where(fresh, zero, state.next_event_idx),
        nominal_steps_committed=torch.where(fresh, zero, state.nominal_steps_committed),
        initialized=torch.ones_like(state.initialized),
    )

    event = state.time_idx >= state.next_event_idx

    # Nominal collision flags at offsets 0..N_N and their prefix AND.
    nom_coll = collision_fn(nom_x, torch.arange(N_N + 1, device=dev))
    nom_safe_prefix = torch.cumprod((~nom_coll).to(torch.int32), dim=-1) > 0

    offsets = lens[:, None] + torch.arange(N_B + 1, device=dev)  # (C, N_B+1)
    ok = ~torch.any(collision_fn(cand_bx, offsets), dim=-1)  # (B, C)
    if terminal_fn is not None:
        ok = ok & terminal_fn(cand_bx[:, :, -1])
    cand_valid = nom_safe_prefix[:, lens] & ok

    found = torch.any(cand_valid, dim=-1)
    best = first_true(cand_valid)  # the longest valid candidate
    best_len = lens[best]  # (B,)

    # The new committed trajectory, fixed shape L.
    idx = torch.arange(L, device=dev)
    nom_part = nom_x[:, torch.clamp(idx, 0, N_N)]
    bk_part = _gather_rows(take_rows(cand_bx, best),
                           torch.clamp(idx - best_len[:, None], 0, N_B))
    new_cx = torch.where((idx <= best_len[:, None])[..., None], nom_part, bk_part)
    idx_u = torch.arange(L - 1, device=dev)
    if N_N > 0:
        nom_u_part = nom_u[:, torch.clamp(idx_u, 0, N_N - 1)]
    else:
        nom_u_part = cand_bu.new_zeros((B, L - 1, m))
    bk_u_part = _gather_rows(take_rows(cand_bu, best),
                             torch.clamp(idx_u - best_len[:, None], 0, N_B - 1))
    new_cu = torch.where((idx_u < best_len[:, None])[..., None], nom_u_part, bk_u_part)
    new_cv = idx_u < (best_len + N_B)[:, None]

    commit = event & found

    if cfg.revalidate:
        # Only the rows the commitment contains count: state row k is
        # reached iff k <= the valid u-row count; later rows are padded
        # copies of the terminal state.
        rem_idx = torch.clamp(state.time_idx[:, None] + idx, 0, L - 1)
        rem_coll = collision_fn(_gather_rows(state.committed_x, rem_idx), idx)
        valid_count = state.committed_valid.sum(-1)
        in_commit = state.time_idx[:, None] + idx <= valid_count[:, None]
        stale = event & ~found & torch.any(rem_coll & in_commit, dim=-1)
    else:
        stale = torch.zeros_like(event)

    committed_x = _where(commit, new_cx, _where(stale, init_cx, state.committed_x))
    committed_u = _where(commit, new_cu, _where(stale, init_cu, state.committed_u))
    committed_valid = _where(commit, new_cv, _where(stale, init_cv, state.committed_valid))
    reset = commit | stale
    time_idx = torch.where(reset, zero, state.time_idx)
    eo = cfg.event_offset_steps
    next_event_idx = torch.where(reset, zero + eo, torch.where(
        event, state.time_idx + eo, state.next_event_idx))
    nominal_steps_committed = torch.where(commit, best_len, torch.where(
        stale, zero, state.nominal_steps_committed))

    # Emit the committed input, or the live backup past the commitment.
    u_idx = torch.clamp(time_idx, 0, L - 2)
    in_range = (time_idx < L - 1) & take_rows(committed_valid, u_idx)
    u = torch.where(in_range[:, None], take_rows(committed_u, u_idx), backup_policy(x))
    using_backup = time_idx >= nominal_steps_committed

    new_state = GatekeeperState(
        committed_x=committed_x,
        committed_u=committed_u,
        committed_valid=committed_valid,
        time_idx=time_idx + 1,
        next_event_idx=next_event_idx,
        nominal_steps_committed=nominal_steps_committed,
        initialized=torch.ones_like(state.initialized),
    )
    return GatekeeperOutput(u=u, state=new_state, using_backup=using_backup,
                            event_fired=event, candidate_found=event & found)

