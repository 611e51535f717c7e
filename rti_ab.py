"""One VTOL2D N=30 RTI solve of the general MPC-CBF, in this tree and in another.

Usage, from the root of a checkout:  python3 rti_ab.py [DIR ...] [--device cpu]

Times ``mpc_cbf.solve_dispatch`` with ``MPCConfig.rti(horizon=30,
num_obs=5)`` (D=120, the general solve) for one robot on the inputs of
``chip_smoke.py`` phase 19d, eagerly, and counts the aten operations one
solve dispatches (``TorchDispatchMode``).  Each tree runs in its own
interpreter with that tree first on ``sys.path``: this one, then each DIR
(e.g. the parent commit unpacked with ``git archive`` under ``build/``),
then this one again, so that the two are compared in turns on one card.
Prints one line a run, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from chip_smoke import card_line

CHILD = r'''
import json, sys, time
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from safe_control_tpu_torch.core.spec import make_spec
from safe_control_tpu_torch.core.types import pad_obstacles
from safe_control_tpu_torch.solvers import mpc_cbf

dev = torch.device(sys.argv[1])
torch.set_num_threads(1)
rti = mpc_cbf.MPCConfig.rti(horizon=30, num_obs=5)
x = torch.tensor([[8.0, 38.0, 0.05, 12.0, 0.5, 0.0]], device=dev)
gl = torch.tensor([[80.0, 40.0, 0, 0, 0, 0]], device=dev)
ob = pad_obstacles([[40.0, 35.0, 3.0, 0, 0, 0, 0]], 5, device=dev)[None]
st = mpc_cbf.init_state("VTOL2D", rti, 1, device=dev)
up = torch.zeros((1, 4), device=dev)
spec = make_spec("VTOL2D")


class Count(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Count.n += 1
        return func(*args, **(kwargs or {}))


def solve():
    return mpc_cbf.solve_dispatch("VTOL2D", spec, x, gl, ob, up, st, 0.05, rti)


solve()  # first-use costs
if dev.type == "cuda":
    torch.cuda.synchronize()
times = []
for _ in range(2):
    t0 = time.perf_counter()
    res = solve()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
with Count():
    solve()
print(json.dumps({"ms": times, "dispatches": Count.n,
                  "u": res.u[0].tolist(), "finite": bool(torch.isfinite(res.state.U).all())}))
'''


def run_tree(root: str, device: str) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", CHILD, device], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise SystemExit(f"rti_ab: the run in {root} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [here] + [os.path.abspath(d) for d in args] + ([here] if args else [])
    card = card_line() if device == "cuda" else "the CPU"
    for root in trees:
        r = run_tree(root, device)
        name = "this tree" if root == here else root
        print(f"rti_ab [{card}] {name}: VTOL2D N=30 MPCConfig.rti one solve on {device}: "
              + ", ".join(f"{t:.1f}" for t in r["ms"]) + f" ms (host clock, eager), "
              f"{r['dispatches']} aten dispatches a solve, u {r['u']}, finite {r['finite']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
