"""The CBF-QP path's tracing: its spans in a sweep step, B2's counter, and
the readers of ``portbench/metrics/`` that read the spans' device time.

On the CPU: a traced step of the DPCBF sweep records ``tracking.step``
holding ``cbf_qp.rows``, ``qp.equilibrate`` and ``qp.finish``, then
``sweep.obstacles``; with tracing off nothing is recorded; without a card
no span is timed on the device; B2's ``LAUNCH_COUNT`` is among the
counters ``trace_to`` reports; the readers give the median of a span's
device time on a synthetic record, and None without a traced slice, on a
port that times no span on the device, or without the span.  On the card
(``gpu``): the same step launches B2 once, inside ``qp.kernel``, and the
counter rises by one a step; the spans opened with ``device=True`` have
their device time, the others none.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import device_spans, harness
from portbench.drivers import common
from safe_control_tpu_torch.solvers import qp_kernel
from safe_control_tpu_torch.utils import profiling

torch.set_num_threads(1)

CELL = "dpcbf_sweep.mc512k"
B2_COUNTER = f"{qp_kernel.__name__}.LAUNCH_COUNT"
DEVICE_SPANS = ("cbf_qp.rows", "qp.equilibrate", "qp.kernel", "qp.finish", "sweep.obstacles")


def new_session():
    """Let the port see tracing off, so that the next profile is a new session."""
    assert not profiling.tracing()


def sweep_driver(device, batch=2):
    c = harness.resolve(harness.load_benchmark(), CELL)
    traffic = {**c["traffic"], "batch": batch}
    return harness.driver_class(traffic)(c["config"], traffic, 2**31 + 23, device)


def step_spans(steps, on_card):
    """The spans of ``steps`` sweep steps as (name, parent) pairs."""
    want = []
    for _ in range(steps):
        top = len(want)
        want.append(("tracking.step", -1))
        want += [("cbf_qp.rows", top), ("qp.equilibrate", top)]
        if on_card:
            want.append(("qp.kernel", top))
        want += [("qp.finish", top), ("sweep.obstacles", -1)]
    return want


def test_sweep_step_records_the_cbf_qp_spans():
    """Two steps of a sweep of two on the CPU (the general QP: no kernel
    span); no span is timed on the device without a card."""
    drv = sweep_driver("cpu")
    state = common.clone_state(drv.episode["state"])
    new_session()
    with profile(activities=[ProfilerActivity.CPU]):
        drv._run(state, 2)
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == step_spans(2, on_card=False)
    for s in got:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            outer = got[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
    assert profiling.device_ms() == {}
    assert device_spans.device_spans({"trace": {}}) == []


def test_sweep_step_records_nothing_with_tracing_off():
    drv = sweep_driver("cpu")
    new_session()
    before, before_dev = profiling.spans(), profiling.device_ms()
    drv._run(common.clone_state(drv.episode["state"]), 1)
    assert profiling.spans() == before and profiling.device_ms() == before_dev


def test_b2_counter_is_reported_by_trace_to(tmp_path):
    """B2's wrapper registers its launch count; ``trace_to`` reports its rise
    over the session (none for a sweep on the CPU, which runs the general QP)."""
    assert B2_COUNTER in profiling._counters
    drv = sweep_driver("cpu")
    with profiling.trace_to(str(tmp_path / "trace")):
        drv._run(common.clone_state(drv.episode["state"]), 1)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert data["port_counters"][B2_COUNTER] == 0


def synthetic(device=None, trace=True):
    rec = {"trace": {"by_name": {}, "counts": {}}} if trace else {"robot_steps": 1}
    if device is not None:
        rec["device_spans"] = device
    return rec


@pytest.mark.parametrize("reader,span", [("cbf_rows_ms.mc512k", "cbf_qp.rows"),
                                         ("qp_finish_ms.mc512k", "qp.finish")])
def test_device_span_readers_on_a_synthetic_record(reader, span, monkeypatch):
    """The median of the span's device ms over the slice's steps: the first
    step's, which holds the host's gaps, does not move it."""
    read = harness.reader(reader).read
    spans = [(span, 40.0), ("qp.kernel", 20.0), (span, 5.0), (span, 6.0), (span, 4.0),
             ("other", 1.0)]
    assert read(synthetic(spans)) == pytest.approx(5.5)
    assert read(synthetic(spans[:3] + spans[4:])) == pytest.approx(5.0)
    assert read(synthetic(spans, trace=False)) is None  # no traced slice
    assert read(synthetic(None)) is None  # a port that times no span on the device
    assert read(synthetic([])) is None
    assert read(synthetic([("qp.kernel", 20.0)])) is None
    # read from the port: one without ``device_ms`` gives None
    monkeypatch.delattr(profiling, "device_ms")
    rec = synthetic()
    assert read(rec) is None and rec["device_spans"] is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B2 has no CPU or interpret mode")
    return "cuda"


@pytest.mark.gpu
def test_traced_sweep_steps_on_the_card(cuda_device, tmp_path):
    """Three steps of a sweep of 256 on the card: one B2 launch a step inside
    ``qp.kernel``, the counter's rise in ``trace_to``, a device time for
    each span opened with ``device=True`` (``tracking.step`` is not), that
    of ``qp.kernel`` at least B2's."""
    drv = sweep_driver(cuda_device, batch=256)
    drv.warmup()
    state = common.clone_state(drv.episode["state"])
    torch.cuda.synchronize()
    with profiling.trace_to(str(tmp_path / "trace")) as prof:
        drv._run(state, 3)
        torch.cuda.synchronize()
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == step_spans(3, on_card=True)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert data["port_counters"][B2_COUNTER] == 3
    dev = profiling.device_ms()
    assert sorted(dev) == [i for i, s in enumerate(got) if s.name in DEVICE_SPANS]
    assert all(ms > 0 for ms in dev.values())
    kernel = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CPU
              and "qp_admm_kernel" in e.name]
    assert len(kernel) == 3
    timed = [dev[i] for i, s in enumerate(got) if s.name == "qp.kernel"]
    for ms, k in zip(timed, kernel):  # the events bracket the launch
        assert ms >= 0.9 * (k.time_range.end - k.time_range.start) * 1e-3
