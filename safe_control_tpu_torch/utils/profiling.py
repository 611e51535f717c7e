"""Tracing of the port: spans on the profiler's clock, the switch that
turns them on, and the exporter.

Port of ``safe_control_tpu/utils/profiling.py``: ``jax.profiler`` becomes
``torch.profiler``.

The switch: tracing is on exactly while a ``torch.profiler`` profile
records in this process (``torch.autograd._profiler_enabled()``); no flag
or environment variable.  :func:`tracing` reads it and, at each change it
sees, starts a new, empty record of spans (on) and calls the functions
registered with :func:`on_switch` (B3's wrapper clears its phase clock's
totals; a captured step captures the variant it lacks: kernels launch
their clocked instantiations only while tracing is on).  The first span or
kernel launch of a session sees the change; so a profile that starts
before the port saw the last one end (no span or launch in between)
continues that session's record; ``trace_to`` always starts a new one.

``span(name)`` marks a region of the host's work.  With tracing off it
costs that one check.  With tracing on it records ``(name, start_ns,
end_ns, parent)`` in memory, stamped with ``time.time_ns()``, the clock of
the profiler's host events, so a span lines up with the device trace; and
it echoes the region into the profile as a host-only event (a ``cpu_op``,
never a ``user_annotation``, which the trace would draw a second time on
the device's timeline as if it were device work).  :func:`spans` gives the
record of the session in progress or of the last one.

``span(name, device=True)`` also times the region's device work: with
tracing on, a card present and no CUDA graph being captured, it records a
CUDA event on the current stream where it opens and one where it closes.
:func:`device_ms` gives the milliseconds between each such pair: the
device's time from finishing the work enqueued before the span to
finishing the span's own, which is the span's device work where the
device is behind the host (and takes in the host's gaps where it is not).
The events cost the host about 25 us a span (an H100's host, under a CPU
profile), so spans whose host time is read keep the default.

    with trace_to("build/trace") as prof:     # the operator's way in
        run(...)
    spans()                                    # the session's spans

``trace_to`` writes the Chrome trace (Perfetto reads it) with, in its
metadata, what is registered with :func:`metadata` (B3's phase totals)
and the rise over the session of each counter registered with
:func:`counter`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, List, NamedTuple

import torch

_enabled = torch.autograd._profiler_enabled
_Echo = torch._C._profiler._RecordFunctionFast  # a host-only profiler event


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: int  # index in the record of the enclosing span, -1 at the top


_on = False  # the switch as last seen
_session = 0  # sessions started
_record: list = []  # [name, start_ns, end_ns, parent] of this session, in start order
_open: list = []  # the open spans, innermost last
_device: dict = {}  # position in _record -> the span's (start, end) CUDA events
_hooks: list = []  # fn(on) called at each switch
_counters: dict = {}  # name -> fn() giving the counter's value
_metadata: dict = {}  # key -> fn() giving a JSON-able value


def on_switch(fn: Callable[[bool], None]) -> None:
    """Call ``fn(on)`` at each change of the switch that the port sees."""
    _hooks.append(fn)


def counter(name: str, read: Callable[[], int]) -> None:
    """Register a running count (``read()`` gives it) for ``trace_to``."""
    _counters[name] = read


def metadata(key: str, read: Callable[[], object]) -> None:
    """Register ``read()`` (JSON-able, read at the session's end) under
    ``key`` in ``trace_to``'s metadata."""
    _metadata[key] = read


def tracing() -> bool:
    """Whether a profiler records in this process; at a change, a new record
    (on) and the :func:`on_switch` functions called.  A change seen during a
    CUDA graph capture waits for the next call outside it (their device
    work would be captured)."""
    on = _enabled()
    if on is not _on:
        _switch(on)
    return on


def _switch(on: bool) -> None:
    global _on, _session, _record, _device
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    _on = on
    if on:
        _session += 1
        _record = []
        _device = {}
    for fn in _hooks:
        fn(on)


def _event_pair():
    """Two timing CUDA events, or None without a card or during a capture."""
    if not torch.cuda.is_available() or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "session", "index", "echo", "events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.events = _event_pair() if device else None

    def __enter__(self):
        self.echo = _Echo(self.name)
        self.echo.__enter__()
        outer = _open[-1] if _open else None
        parent = outer.index if outer is not None and outer.session == _session else -1
        self.session, self.index = _session, len(_record)
        _record.append([self.name, time.time_ns(), 0, parent])
        _open.append(self)
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.pop()
        if self.session == _session:  # not a span left open across a session's start
            _record[self.index][2] = end
            if self.events is not None:
                self.events[1].record()
                _device[self.index] = self.events
        self.echo.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A region of the host's work, recorded while tracing is on (see the
    module's docstring); a no-op otherwise.  ``device``: also time its
    device work (:func:`device_ms`)."""
    return _Span(name, device) if tracing() else _OFF


def spans() -> List[Span]:
    """The spans of the session in progress, or of the last one, in the
    order they started (a ``parent`` is a position in this list); a span
    still open has ``end_ns`` 0."""
    return [Span(*r) for r in _record]


def device_ms() -> dict:
    """``{position in spans(): device milliseconds}`` of the session's
    closed spans opened with ``device=True`` that recorded their CUDA events
    (none without a card); waits for their device work to finish."""
    out = {}
    for i, (start, end) in _device.items():
        end.synchronize()
        out[i] = start.elapsed_time(end)
    return out


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with CPU activity, and CUDA activity where a card
    is present; yields the ``torch.profiler.profile`` and writes its Chrome
    trace to ``logdir/trace.json`` (viewable in Perfetto), the spans among
    its host events.  Its metadata hold each :func:`metadata` entry (B3's
    wrapper registers ``b3_phases``, its phase clock over the session; null
    where B3 made no launch on a card) and ``port_counters`` (each
    registered counter's rise over the session)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = {name: read() for name, read in _counters.items()}
    tracing()  # sees any earlier profile's end, so that this one is a new session
    with torch.profiler.profile(activities=activities) as prof:
        tracing()  # the session's start, even if the block has no span
        yield prof
        for key, read in _metadata.items():
            prof.add_metadata_json(key, json.dumps(read()))
        after = {name: read() for name, read in _counters.items()}
        prof.add_metadata_json("port_counters", json.dumps(
            {k: v - before.get(k, 0) for k, v in after.items()}))
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
