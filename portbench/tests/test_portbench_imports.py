"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the port: each checked in a fresh interpreter,
by the top-level name of every loaded module compared whole (the port's
name begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HELD = json.loads((ROOT / "portbench" / "held_back.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"] + HELD["workloads"]]
TINY = {"batch": 2, "samples": 1}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_harness_loads_no_jax(cell):
    """The run's imports, the cell's driver, its objects and every metric
    reader the cell reports."""
    code = f"""
import portbench.run
from portbench import harness, control
c = harness.resolve(harness.load_benchmark(held_back=True), {cell!r})
for m in c["end_to_end"] + c["per_layer"]:
    harness.reader(m["name"])
traffic = {{**c["traffic"], **{{k: v for k, v in {TINY!r}.items() if k in c["traffic"]}}}}
harness.driver_class(traffic)(c["config"], traffic, 1, "cpu")
"""
    top = loaded_after(code)
    assert "safe_control_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "safe_control_tpu"}


def test_reference_loads_nothing_of_the_port():
    top = loaded_after("import portbench.reference.tracking, portbench.reference.models, "
                       "portbench.roofline, portbench.generate, portbench.trace")
    assert not top & {"safe_control_tpu_torch", "safe_control_tpu", "jax", "jaxlib"}
