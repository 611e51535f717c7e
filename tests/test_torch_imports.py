"""The port stands alone: with imports of ``jax`` and of the JAX package
``safe_control_tpu`` (not ``safe_control_tpu_torch``) blocked, every module
of ``safe_control_tpu_torch`` imports, and so does ``chip_smoke.py`` (loaded
as a module; its ``main`` is not run).  Checked in a fresh interpreter, since
this process has imported JAX for the parity tests."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib
import importlib.abc
import importlib.util
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "safe_control_tpu")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import safe_control_tpu_torch

names = [m.name for m in pkgutil.walk_packages(safe_control_tpu_torch.__path__,
                                               "safe_control_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
assert callable(module.main)
loaded = sorted(m for m in sys.modules if blocked(m))
assert not loaded, loaded
print(len(names), " ".join(names))
'''


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    count, *names = out.stdout.split()
    assert int(count) == len(names) >= 60
    for name in ("envs.warehouse_env", "sim.warehouse_sim", "parallel.fleet", "parallel.mesh",
                 "utils.profiling", "utils.helpers", "envs.env"):
        assert "safe_control_tpu_torch." + name in names
