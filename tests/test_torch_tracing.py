"""The port's tracing (``utils/profiling.py``) and the benchmark's readers of it.

On the CPU: spans nest and name their parents; with tracing off a span
records nothing; under a profiler a span's stamps lie within its echo, a
host-only ``cpu_op`` event; a new session starts empty; the fleet's
tracking step and the controller's step record their spans; the readers
of ``portbench/metrics/`` (B3's phase groups and active rows, the spans'
means) give the value their metric defines on a synthetic record, and None
without data.  On the card (``gpu``): a traced slice of the fleet cell puts
no span on the device's timeline, B3's four phase groups take 85-100% of
its blocks' cycles, and B3's outputs are the same with its clock on and off;
a captured step replays the clocked B3 while tracing is on, the same bits.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import harness
from portbench import trace as trace_mod
from portbench.drivers import common
from safe_control_tpu_torch.utils import profiling

torch.set_num_threads(1)

# The slack of comparing a span's stamps with its echo: the profiler keeps
# an event's times as floating-point microseconds from its start.
ECHO_SLACK_NS = 1000


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def new_session():
    """Let the port see tracing off, so that the next profile is a new session."""
    assert not profiling.tracing()


def test_span_nesting_and_parents():
    new_session()
    with cpu_profile():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    torch.ones(4).sum()
            with profiling.span("d"):
                pass
        with pytest.raises(ValueError):
            with profiling.span("e"):
                raise ValueError("a span passes an exception on")
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("a", -1), ("b", 0), ("c", 1), ("d", 0),
                                                 ("e", -1)]
    for s in got:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            outer = got[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
    assert got[1].end_ns <= got[3].start_ns and got[0].end_ns <= got[4].start_ns


def test_span_records_nothing_with_tracing_off():
    new_session()
    before = profiling.spans()
    with profiling.span("off"):
        with profiling.span("off.inner"):
            torch.ones(4).sum()
    assert profiling.spans() == before
    assert not any(s.name.startswith("off") for s in profiling.spans())


def test_span_lies_within_its_echo_a_host_only_event(tmp_path):
    new_session()
    with cpu_profile() as prof:
        with profiling.span("probe"):
            torch.ones(8).exp().sum()
    (s,) = profiling.spans()
    base = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "probe"]
    assert ev.device_type == torch.autograd.DeviceType.CPU
    assert base + round(ev.time_range.start * 1e3) - ECHO_SLACK_NS <= s.start_ns
    assert s.end_ns <= base + round(ev.time_range.end * 1e3) + ECHO_SLACK_NS
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {e.get("cat") for e in events if e.get("name") == "probe"} == {"cpu_op"}


def test_a_new_session_starts_empty(monkeypatch):
    """Each session's record starts empty, and each change of the switch
    calls the ``on_switch`` functions once."""
    new_session()
    seen = []
    monkeypatch.setattr(profiling, "_hooks", list(profiling._hooks))
    profiling.on_switch(seen.append)
    with cpu_profile():
        with profiling.span("first"):
            pass
    assert [s.name for s in profiling.spans()] == ["first"]
    with profiling.span("between"):  # tracing off: the port sees the session end
        pass
    assert [s.name for s in profiling.spans()] == ["first"]
    with cpu_profile():
        with profiling.span("second"):
            pass
    assert [s.name for s in profiling.spans()] == ["second"]
    assert seen == [True, False, True]


def _cell(name, **traffic):
    c = harness.resolve(harness.load_benchmark(), name)
    return c, {**c["traffic"], **traffic}


def test_tracking_step_records_its_solve():
    """Two steps of a fleet of two on the CPU: each ``tracking.step`` holds
    its ``tracking.solve``; the enqueue reader reads the first step."""
    c, traffic = _cell("du_fleet.track", batch=2)
    drv = harness.driver_class(traffic)(c["config"], traffic, 2**31 + 11, "cpu")
    ep = drv.episode
    new_session()
    with cpu_profile():
        drv._run(ep["state"], ep, 2)
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("tracking.step", -1), ("tracking.solve", 0),
                                                 ("tracking.step", -1), ("tracking.solve", 2)]
    steps = [(s.end_ns - s.start_ns) * 1e-6 for s in got if s.name == "tracking.step"]
    rec = {"trace": {"by_name": {}, "counts": {}}}
    assert harness.reader("tracking_enqueue_ms.batch").read(rec) == pytest.approx(steps[0])
    assert rec["program"]["b3"] is None  # B3 ran as its plain version
    assert harness.reader("b3_factor_ms.batch").read(rec) is None


def test_controller_step_records_its_parts():
    """One control step on the CPU (eager: the replay span holds the
    tracking step); the controller readers on its spans."""
    c, traffic = _cell("du_single.ctrl")
    drv = harness.driver_class(traffic)(c["config"], traffic, 2**31 + 11, "cpu")
    ctrl = drv._new(drv.first)
    new_session()
    with cpu_profile():
        ctrl.control_step()
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [
        ("controller.step", -1), ("controller.inputs", 0), ("controller.replay", 0),
        ("tracking.step", 2), ("tracking.solve", 3), ("controller.keep", 0),
        ("controller.read", 0)]
    ms = {s.name: (s.end_ns - s.start_ns) * 1e-6 for s in got}
    rec = {"trace": {"by_name": {}, "counts": {}}}
    assert harness.reader("controller_read_ms.single").read(rec) == pytest.approx(
        ms["controller.read"])
    assert harness.reader("controller_host_ms.single").read(rec) == pytest.approx(
        ms["controller.step"] - ms["controller.read"])


B3_NAME = "void (anonymous namespace)::mpc_fused_kernel<(anonymous namespace)::...>"
CYCLES = dict(prologue=5, jacobian=20, rows=3, hessian=10, damping=2, cholesky=30,
              substitutions=15, linesearch=12, multipliers=2, epilogue=1)
B3_TOTALS = dict(cycles=CYCLES, entries={}, active_rows=600, newton_steps=48, total=100)
B3_READERS = ["b3_factor_ms.batch", "b3_factor_ms.single", "b3_jacobian_ms.batch",
              "b3_jacobian_ms.single", "b3_linesearch_ms.batch", "b3_linesearch_ms.single",
              "b3_hessian_ms.batch", "b3_hessian_ms.single", "b3_active_rows.batch"]
SPAN_READERS = ["tracking_enqueue_ms.batch", "controller_read_ms.single",
                "controller_host_ms.single"]


def synthetic(spans=None, b3=None, launches=10, seconds=0.05):
    """A traced slice's record: B3 ``launches`` launches taking ``seconds``
    of device time, and what the port recorded."""
    red = {"by_name": {B3_NAME: seconds} if launches else {},
           "counts": {B3_NAME: launches} if launches else {}}
    return {"trace": red, "program": {"spans": spans, "b3": b3}}


def test_b3_readers_on_a_synthetic_record():
    """5 ms a launch, of it the phases' shares of the cycles; active rows a
    Newton step a problem."""
    rec = synthetic(b3=B3_TOTALS)
    want = {"b3_factor_ms": 5 * 0.45, "b3_jacobian_ms": 5 * 0.20, "b3_linesearch_ms": 5 * 0.12,
            "b3_hessian_ms": 5 * 0.15}
    for name in B3_READERS[:-1]:
        assert harness.reader(name).read(rec) == pytest.approx(want[name.split(".")[0]])
    assert harness.reader("b3_active_rows.batch").read(rec) == pytest.approx(12.5)
    for name in B3_READERS:
        read = harness.reader(name).read
        assert read({"latencies_ms": [1.0]}) is None  # no traced slice
        assert read(synthetic()) is None  # a port without the clock, or B3's plain version
        assert read(synthetic(b3={**B3_TOTALS, "newton_steps": 0, "total": 0})) is None
    for name in B3_READERS[:-1]:
        assert harness.reader(name).read(synthetic(b3=B3_TOTALS, launches=0)) is None


def test_span_readers_on_a_synthetic_record():
    ms = 1_000_000
    spans = [("controller.step", 0, 3 * ms, -1), ("controller.inputs", 100, 200, 0),
             ("controller.read", 1 * ms, 2.5 * ms, 0), ("controller.step", 10 * ms, 13 * ms, -1),
             ("controller.read", 11 * ms, 12 * ms, 3), ("tracking.step", 20 * ms, 21 * ms, -1),
             ("tracking.step", 30 * ms, 33 * ms, -1), ("tracking.step", 40 * ms, 0, -1)]
    rec = synthetic(spans=spans)
    assert harness.reader("controller_read_ms.single").read(rec) == pytest.approx(1.25)
    assert harness.reader("controller_host_ms.single").read(rec) == pytest.approx(1.75)
    assert harness.reader("tracking_enqueue_ms.batch").read(rec) == pytest.approx(1.0)
    for name in SPAN_READERS:
        read = harness.reader(name).read
        assert read({"latencies_ms": [1.0]}) is None
        assert read(synthetic()) is None  # a port that keeps no spans
        assert read(synthetic(spans=[])) is None
        assert read(synthetic(spans=[("other", 0, ms, -1)])) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B3 and its phase clock run only on a card")
    return "cuda"


@pytest.mark.gpu
def test_traced_fleet_slice_on_the_card(cuda_device):
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    c, traffic = _cell("du_fleet.track", trace_steps=5, warmup_steps=2)
    drv = harness.driver_class(traffic)(c["config"], traffic, 2**31 + 5, cuda_device)
    drv.warmup()
    drv.state, drv.ep = common.clone_state(drv.episode["state"]), drv.episode
    new_session()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drv.traced_slice(lambda: record_function(trace_mod.SLICE))
    events = trace_mod.events_of(prof)
    names = {s.name for s in profiling.spans()}
    assert names == {"tracking.step", "tracking.solve"}
    assert not names & {name for name, on_device, _, _ in events if on_device}
    totals = mf.trace_totals()
    groups = ("jacobian", "rows", "hessian", "damping", "cholesky", "substitutions",
              "linesearch")
    share = sum(totals["cycles"][p] for p in groups) / totals["total"]
    assert 0.85 <= share <= 1.0
    mpc = c["config"]["mpc"]
    assert totals["newton_steps"] == 5 * traffic["batch"] * mpc["outer_iters"] * mpc["newton_iters"]
    rec = {"trace": trace_mod.reduce_events(events)}
    seconds, launches = trace_mod.kernel_time(rec["trace"], "mpc_fused_kernel")
    parts = sum(harness.reader(f"b3_{g}_ms.batch").read(rec)
                for g in ("factor", "jacobian", "linesearch", "hessian"))
    assert parts == pytest.approx(1e3 * seconds / launches * share)

    cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    _, args = entry.build_fused_step(4096, model_name=DYNAMIC_UNICYCLE_2D, horizon=10,
                                        device=cuda_device)
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    new_session()
    off = mf.solve_fused_batch(DYNAMIC_UNICYCLE_2D, spec, *args, entry.DT, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = mf.solve_fused_batch(DYNAMIC_UNICYCLE_2D, spec, *args, entry.DT, cfg)
        torch.cuda.synchronize()
    assert mf.trace_totals()["newton_steps"] == 4096 * 24
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_captured_step_follows_the_switch_on_the_card(cuda_device):
    """A captured step that launches B3 keeps a graph for each state of the
    switch: the traced one is captured when the port sees tracing turn on,
    replays B3's clocked instantiation, and gives the untraced graph's bits;
    after the profile the untraced graph replays again.  Every call counts
    one launch, in one-warp blocks (M=20), as an eager launch does."""
    from safe_control_tpu_torch import entry
    from safe_control_tpu_torch.core import graphs
    from safe_control_tpu_torch.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
    from safe_control_tpu_torch.solvers import mpc_cbf
    from safe_control_tpu_torch.solvers import mpc_fused as mf

    cfg = mpc_cbf.MPCConfig(horizon=10, num_obs=5)
    _, args = entry.build_fused_step(4, model_name=DYNAMIC_UNICYCLE_2D, horizon=10,
                                     device=cuda_device)
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    step = graphs.CapturedStep(
        lambda *a: tuple(mf.solve_fused_batch(DYNAMIC_UNICYCLE_2D, spec, *a, entry.DT, cfg)),
        True)
    new_session()
    counts = lambda: (mf.LAUNCH_COUNT, mf.NARROW_LAUNCH_COUNT)
    before = counts()
    off = [t.clone() for t in step(*args)]
    assert step.clocked and list(step.graphs) == [False]
    assert counts() == (before[0] + 2, before[1] + 2)  # the warm-up and the first replay
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert profiling.tracing()
        assert set(step.graphs) == {False, True}
        on = [t.clone() for t in step(*args)]
        torch.cuda.synchronize()
    assert mf.trace_totals()["newton_steps"] == 4 * cfg.outer_iters * cfg.newton_iters
    new_session()
    again = step(*args)
    torch.cuda.synchronize()
    assert mf.trace_totals()["newton_steps"] == 4 * cfg.outer_iters * cfg.newton_iters
    assert counts() == (before[0] + 4, before[1] + 4)
    for a, b, c in zip(off, on, again):
        assert torch.equal(a, b) and torch.equal(a, c)
