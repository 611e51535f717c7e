"""Tiny sizes of the cells that ``tests/tiny.py``'s table lacks, merged into
that table before the benchmark's tests collect, so that each of them runs
every cell of ``BENCHMARK.json`` on the CPU."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.tests.tiny import TINY  # noqa: E402

MORE = {
    "dpcbf_sweep.mc512k": {"traffic": {"batch": 4, "chunk": 2, "episode": 3, "warmup_steps": 1,
                                       "samples": 3, "trace_steps": 1}},
}

for _cell, _tiny in MORE.items():
    TINY.setdefault(_cell, _tiny)
