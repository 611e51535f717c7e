"""A step function captured once as a CUDA graph and replayed.

On a card the first call warms the function up on a side stream (so that
every device constant it makes exists before the capture, see
``core.types.device_constant``), captures it on private copies of its
inputs and replays it; every later call copies its inputs into those
static tensors and replays.  The outputs are the graph's static tensors,
overwritten by the next call.  Without ``use_graph`` the function runs
eagerly.  The inputs are tensors and tuples of them, of fixed shapes.
"""

from __future__ import annotations

import ctypes
import time

import torch

_tree = torch.utils._pytree


class CapturedStep:
    """``fn(*inputs) -> outputs``, captured at the first call when
    ``use_graph``.  ``capture_seconds``: the capture's wall time, warm-up
    included, once it is made."""

    def __init__(self, fn, use_graph: bool):
        self.fn = fn
        self.use_graph = use_graph
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.capture_seconds = None

    def __call__(self, *inputs):
        if not self.use_graph:
            return self.fn(*inputs)
        if self.graph is None:
            self._capture(inputs)
        else:
            for dst, src in zip(_tree.tree_leaves(self.static_in), _tree.tree_leaves(inputs)):
                if dst is not src:  # an output fed back unchanged is already in place
                    dst.copy_(src)
        self.graph.replay()
        return self.static_out

    def _capture(self, inputs):
        t0 = time.perf_counter()
        self.static_in = _tree.tree_map(torch.clone, inputs)
        dev = _tree.tree_leaves(inputs)[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        try:  # keep the cudaGraph_t, for graph_nodes()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:
            self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = self.fn(*self.static_in)
        if hasattr(self.graph, "instantiate"):
            self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0

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
