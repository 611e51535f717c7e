"""Structured metrics, accumulated on the device, and CSV logging.

The port's own copy of ``safe_control_tpu/utils/metrics.py``: a typed
tuple of tensors updated without branches inside a loop (for a whole batch
at once), rendered on the host by ``summarize``, and a CSV logger of states
and controls in the reference tracker's format.
"""

from __future__ import annotations

import csv
from typing import NamedTuple

import numpy as np
import torch


class StepMetrics(NamedTuple):
    h_min: torch.Tensor  # min barrier value seen
    infeasible_steps: torch.Tensor  # int64 count
    backup_steps: torch.Tensor  # int64 count (shielding engaged)
    nominal_steps: torch.Tensor  # int64 count
    replans_accepted: torch.Tensor  # int64 (gatekeeper commits)
    replans_rejected: torch.Tensor  # int64


def init_metrics(*, device=None, dtype=torch.float32) -> StepMetrics:
    z = lambda: torch.zeros((), dtype=torch.long, device=device)
    return StepMetrics(h_min=torch.full((), float("inf"), dtype=dtype, device=device),
                       infeasible_steps=z(), backup_steps=z(), nominal_steps=z(),
                       replans_accepted=z(), replans_rejected=z())


def update_metrics(m: StepMetrics, h=None, infeasible=None, using_backup=None,
                   replanned=None, event=None) -> StepMetrics:
    """Branch-free accumulation; every argument optional."""
    h_min = m.h_min if h is None else torch.minimum(m.h_min, h)
    inf_c = m.infeasible_steps if infeasible is None else m.infeasible_steps + infeasible.long()
    if using_backup is not None:
        b = m.backup_steps + using_backup.long()
        n = m.nominal_steps + (~using_backup).long()
    else:
        b, n = m.backup_steps, m.nominal_steps
    if replanned is not None and event is not None:
        acc = m.replans_accepted + (event & replanned).long()
        rej = m.replans_rejected + (event & ~replanned).long()
    else:
        acc, rej = m.replans_accepted, m.replans_rejected
    return StepMetrics(h_min, inf_c, b, n, acc, rej)


def summarize(m: StepMetrics) -> dict:
    """Host-side dict: Python scalars for 0-d fields, arrays otherwise."""
    out = {}
    for k, v in m._asdict().items():
        arr = v.detach().cpu().numpy()
        out[k] = arr.item() if arr.ndim == 0 else arr
    return out


class CSVLogger:
    """State and control CSV logging in the reference tracker's format."""

    def __init__(self, path: str, header=("states", "control_inputs", "alpha1", "alpha2")):
        self.path = path
        self._fh = open(path, "w", newline="")
        self._writer = csv.writer(self._fh)
        self._writer.writerow(list(header))

    def log(self, state, control, extras=()):
        as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                           else np.asarray(a)).ravel()
        self._writer.writerow(np.concatenate([as_np(state), as_np(control), as_np(extras)]))

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
