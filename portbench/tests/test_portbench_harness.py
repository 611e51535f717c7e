"""The harness rehearsed on the CPU: every cell and metric resolves to its
files, the traffic repeats by seed, the arithmetic of the metrics, each
cell's loop at a tiny size through the port's plain paths, and the refusals
of ``run.py``."""

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generate, harness, roofline, trace
from portbench.drivers import common
from portbench.tests.tiny import TINY

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark(held_back=True)  # with the cells BENCHMARK.json leaves out
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(BENCH, cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert harness.driver_class(c["traffic"]).__name__ == "Driver"
    assert c["limits"]["limits"]
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("held_back", [False, True])
def test_every_metric_names_its_cells_and_what_it_moves(held_back):
    bench = harness.load_benchmark(held_back)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_route_starts_repeat_by_seed():
    c = harness.resolve(BENCH, "du_fleet.track")
    draw = lambda seed: generate.route_starts(c["config"]["scene"], 0.25, c["traffic"],
                                              generate.generator(seed), 64)
    a, b, d = draw(2**31 + 9), draw(2**31 + 9), draw(2**31 + 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], d[0])
    wps, n = generate.route_waypoints(c["config"]["scene"], a[1])
    assert (n >= 1).all() and torch.equal(wps[:, 0], torch.tensor(
        c["config"]["scene"]["waypoints"])[a[1]])
    # every start clear of every obstacle by the robot's radius
    obs = torch.tensor([o[:3] for o in c["config"]["scene"]["obstacles"]])
    gap = torch.cdist(a[0][:, :2], obs[:, :2]) - obs[:, 2] - 0.25
    assert (gap > 0).all()


def test_dpcbf_scenarios_and_samples_repeat_by_seed():
    c = harness.resolve(BENCH, "dpcbf_sweep.mc")
    draw = lambda seed: generate.dpcbf_scenarios(c["config"]["scene"], c["traffic"],
                                                 generate.generator(seed), 32)[0]
    assert torch.equal(draw(7), draw(7)) and not torch.equal(draw(7), draw(8))
    offsets = [common.capture_offsets(2**31 + 7, e, 400) for e in range(6)]
    assert offsets == [common.capture_offsets(2**31 + 7, e, 400) for e in range(6)]
    assert all(o[0] == 0 and 1 <= o[1] < 400 for o in offsets)
    assert offsets != [common.capture_offsets(2**31 + 8, e, 400) for e in range(6)]
    # the steps checked: drawn from the seed over every episode, the first
    # step after the first draw inside the window always among them
    caps = [dict(episode=e, offset=o) for e in range(6) for o in offsets[e]]
    pick = lambda seed: [(c["episode"], c["offset"]) for c in common.choose(seed, caps, 4)]
    assert pick(7) == pick(7) and len(pick(7)) == 4 and (1, 0) in pick(7)
    assert len({tuple(pick(s)) for s in range(8)}) > 1
    assert len(common.choose(7, caps, 20)) == len(caps)


def test_rate_is_all_work_over_the_whole_window_and_p95_over_all_steps():
    rate = harness.reader("robot_steps_per_s")
    assert rate.read({"robot_steps": 4096 * 300, "window_s": 4.0}) == 4096 * 300 / 4.0
    assert rate.read({"latencies_ms": [1.0]}) is None
    p95 = harness.reader("step_ms_p95")
    lat = list(np.arange(1, 401, dtype=float))  # one latency a step, each from its due time
    assert p95.read({"latencies_ms": lat}) == pytest.approx(np.percentile(lat, 95))
    assert p95.read({"robot_steps": 1, "window_s": 1.0}) is None


def test_idle_share_is_a_union_of_intervals():
    events = [(trace.SLICE, False, 0.0, 100.0), (trace.SLICE, True, 0.0, 100.0),
              ("k1", True, 10.0, 30.0), ("k2", True, 20.0, 40.0),  # overlap: 30 us busy
              ("k1", True, 60.0, 70.0), ("host_op", False, 40.0, 60.0),
              ("k3", True, 95.0, 120.0)]  # clipped to the slice: 5 us
    red = trace.reduce_events(events)
    assert red["busy_s"] == pytest.approx(45e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    idle = harness.reader("device_idle_pct.batch").read({"trace": red})
    assert idle == pytest.approx(55.0)
    # the idle gaps, longest first, each named by the host operation in flight
    assert [g[0] for g in red["gaps"]] == ["host idle", "host_op", "host idle"]
    assert [g[1] for g in red["gaps"]] == pytest.approx([25e-6, 20e-6, 10e-6])
    assert trace.kernel_time(red, "k1") == (pytest.approx(30e-6), 2)
    assert harness.reader("device_busy_ms.single").read(
        {"trace": red, "trace_steps": 3}) == pytest.approx(45e-3 / 3)


def test_frozen_operation_counts_equal_the_chip_smoke_ones():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    for args in [(1024, 2, 10, 400), (4096, 2, 7, 1600), (1365, 3, 118, 800)]:
        assert roofline.b2_flops(*args) == cs.b2_flops(*args)
    for args in [(4096, 4, 2, 10, 5, 70, 17, 12345, 6, 2), (64, 6, 4, 30, 5, 300, 189, 7, 6, 2)]:
        assert roofline.b3_flops(*args) == cs.b3_flops(*args)
        assert roofline.b3_bytes(*args[:5]) == cs.b3_bytes(*args[:5])
    obs = torch.zeros(10, 5, 7)
    obs[:3, :2, 6] = 1.0
    assert roofline.b1_flops(44, 50, 10, 999) == cs.b1_flops(obs, 999)
    assert cs.FP32_PEAK == roofline.FP32_PEAK and cs.HBM_RATE == roofline.HBM_RATE


def test_roofline_shares_from_a_trace():
    c = harness.resolve(BENCH, "du_fleet.track")
    name = "void mpc_fused_kernel<...>"
    red = {"by_name": {name: 0.5}, "counts": {name: 50}}
    rec = {"trace": red, "config": c["config"], "traffic": c["traffic"],
           "active_rows_per_problem": 300.0}
    share = harness.reader("b3_roofline_pct.batch").read(rec)
    flops = roofline.b3_flops(4096, 4, 2, 10, 5, 70, 17, 300.0 * 4096, 6.0, 2)
    assert share == pytest.approx(100 * flops / roofline.FP32_PEAK / 0.01)
    assert harness.reader("b3_roofline_pct.batch").read({**rec, "trace": None}) is None
    s = harness.resolve(BENCH, "dpcbf_sweep.mc")
    name = "qp_admm_kernel<2, 16, 1>"
    red = {"by_name": {name: 0.02}, "counts": {name: 50}}
    share = harness.reader("b2_roofline_pct.batch").read(
        {"trace": red, "config": s["config"], "traffic": s["traffic"]})
    assert share == pytest.approx(100 * roofline.b2_flops(1024, 2, 10, 400)
                                  / roofline.FP32_PEAK / 4e-4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_a_few_steps_on_the_cpu(cell):
    r = harness.run_cell(cell, 2**31 + 3, 0.0, trace=True, device="cpu",
                         overrides=TINY[cell], log=lambda *_: None, bench=BENCH)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["platform"] == "cpu"
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                      "checks"}
    assert list(r)[-1] == "checks"
    json.dumps(r, allow_nan=False)


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "du_fleet.track",
                           "--seed", "3", "--seconds", "1", *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_from_the_benchmark_files_alone_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, cuda_device):
    r = harness.run_cell(cell, 2**31 + 17, 1.0, trace=True, device=cuda_device,
                         log=lambda *_: None, bench=BENCH)
    assert r["correct"], r["checks"]
    assert math.isfinite(r["device"]["busy_s"]) and r["device"]["busy_s"] > 0
