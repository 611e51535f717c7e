"""A step function captured once as a CUDA graph and replayed.

On a card the first call warms the function up on a side stream (so that
every device constant it makes exists before the capture, see
``core.types.device_constant``), captures it on private copies of its
inputs and replays it; every later call copies its inputs into those
static tensors and replays.  The outputs are the graph's static tensors,
overwritten by the next call.  Without ``use_graph`` the function runs
eagerly.  The inputs are tensors and tuples of them, of fixed shapes.

A kernel wrapper counts its launches in its module's ``LAUNCH_COUNT`` (and
may count some of them again in other counters) when its Python code runs,
which a replay skips.  Each wrapper's module registers itself and its
counters with :func:`count_launches` when it is imported; the capture notes
how far each registered count rose while it recorded (no launch: the kernel
is only recorded), takes that back, and every replay adds it, as the replay
launches the recorded kernels.  The warm-up's launches are real and stay
counted (``warmup_launches``).

A kernel whose wrapper registers with ``clocked=True`` runs another
instantiation, with a clock, while tracing is on (``utils.profiling``).  A
step that launches one keeps a graph for each state of the switch, both on
the same static inputs: the one it lacks is captured when the switch
changes (before the span that saw the change opens), or at the call.
"""

from __future__ import annotations

import ctypes
import sys
import time
import weakref

import torch

from safe_control_tpu_torch.utils import profiling

_tree = torch.utils._pytree

# name -> module of each kernel wrapper that counts its launches in a LAUNCH_COUNT
COUNTED: dict = {}
# name -> the module's counters of launches: LAUNCH_COUNT and any others
COUNTERS: dict = {}
# names of those whose kernel has a clocked instantiation
CLOCKED: set = set()
# The captured steps, for the tracing switch.
_STEPS = weakref.WeakSet()


def count_launches(module_name: str, clocked: bool = False, also: tuple = ()) -> None:
    """Register a kernel wrapper's module (call it from the module, with
    ``__name__``): captures and replays keep its ``LAUNCH_COUNT`` true, and
    the module's counters named in ``also`` (launches of some kind), and
    ``profiling.trace_to`` reports each.  ``clocked``: its launches run
    another instantiation while tracing is on."""
    module = COUNTED[module_name] = sys.modules[module_name]
    COUNTERS[module_name] = ("LAUNCH_COUNT", *also)
    if clocked:
        CLOCKED.add(module_name)
    for attr in COUNTERS[module_name]:
        profiling.counter(f"{module_name}.{attr}", lambda attr=attr: getattr(module, attr))


def _counts() -> dict:
    """(module name, counter) -> its count, over every registered counter."""
    return {(name, attr): getattr(module, attr) for name, module in COUNTED.items()
            for attr in COUNTERS[name]}


def _rise(before: dict, after: dict) -> dict:
    return {key: after[key] - before.get(key, 0) for key in after
            if after[key] != before.get(key, 0)}


def _launches(rise: dict) -> dict:
    """Of the counters' rise, each module's launches."""
    return {name: n for (name, attr), n in rise.items() if attr == "LAUNCH_COUNT"}


def _add(rise: dict, sign: int) -> None:
    for (name, attr), n in rise.items():
        module = COUNTED[name]
        setattr(module, attr, getattr(module, attr) + sign * n)


class CapturedStep:
    """``fn(*inputs) -> outputs``, captured at the first call when
    ``use_graph``.  ``capture_seconds``: the first capture's wall time,
    warm-up included, once it is made; ``warmup_out`` and
    ``warmup_seconds``: the warm-up's outputs (an eager step on the first
    call's inputs, which the first replay reproduces) and its wall time.
    ``graph``, ``static_out`` and ``launches`` (kernel module -> launches a
    replay): the first capture's; ``clocked``: whether the step launches a
    kernel with a clock."""

    def __init__(self, fn, use_graph: bool):
        self.fn = fn
        self.use_graph = use_graph
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.capture_seconds = None
        self.launches = {}
        self.graphs = {}  # tracing on -> (graph, outputs, counters' rise a replay)
        self.clocked = False
        self.warmup_launches = {}  # kernel module -> launches of the warm-up run
        self.warmup_out = None
        self.warmup_seconds = None
        _STEPS.add(self)

    def __call__(self, *inputs):
        if not self.use_graph:
            return self.fn(*inputs)
        if self.graph is None:
            self._capture(inputs)
        else:
            for dst, src in zip(_tree.tree_leaves(self.static_in), _tree.tree_leaves(inputs)):
                if dst is not src:  # an output fed back unchanged is already in place
                    dst.copy_(src)
        on = self.clocked and profiling.tracing()
        graph, out, rise = self.graphs.get(on) or self._record(on)
        graph.replay()
        _add(rise, 1)
        return out

    def _capture(self, inputs):
        t0 = time.perf_counter()
        self.static_in = _tree.tree_map(torch.clone, inputs)
        dev = _tree.tree_leaves(inputs)[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = _counts()
        with torch.cuda.stream(side):
            self.warmup_out = self.fn(*self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_seconds = time.perf_counter() - t0
        self.warmup_launches = _launches(_rise(before, _counts()))
        self.clocked = not CLOCKED.isdisjoint(self.warmup_launches)
        self.graph, self.static_out, rise = self._record(self.clocked and profiling.tracing())
        self.launches = _launches(rise)
        self.capture_seconds = time.perf_counter() - t0

    def _record(self, on: bool):
        """Capture ``fn`` on the static inputs with tracing ``on`` as it is
        now: (graph, outputs, the counters' rise a replay)."""
        dev = _tree.tree_leaves(self.static_in)[0].device
        try:  # keep the cudaGraph_t, for graph_nodes()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:
            graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.graph(graph):
            out = self.fn(*self.static_in)
        rise = _rise(before, _counts())
        _add(rise, -1)  # recorded, not launched
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        torch.cuda.synchronize(dev)
        self.graphs[on] = (graph, out, rise)
        return self.graphs[on]

    def graph_nodes(self):
        """Nodes of the captured graph (``cudaGraphGetNodes``), if PyTorch
        exposes the graph and the CUDA runtime library loads (else None)."""
        if self.graph is None:
            return None
        try:
            raw = self.graph.raw_cuda_graph()
        except (AttributeError, RuntimeError):
            return None
        for name in ("libcudart.so.12", "libcudart.so", "libcudart.so.13"):
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            n = ctypes.c_size_t(0)
            err = lib.cudaGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
            return int(n.value) if err == 0 else None
        return None


def _follow_switch(on: bool) -> None:
    """Capture, for each step captured so far that launches a kernel with a
    clock, its graph for the switch's new state if it has none."""
    for step in list(_STEPS):
        if step.clocked and on not in step.graphs:
            step._record(on)


profiling.on_switch(_follow_switch)
