"""Each cell cut to a size the CPU runs in seconds, through the port's
plain paths."""

TINY = {
    "du_fleet.track": {"traffic": {"batch": 2, "chunk": 1, "episode": 2, "warmup_steps": 1,
                                   "samples": 2, "trace_steps": 1}},
    "dpcbf_sweep.mc": {"traffic": {"batch": 4, "chunk": 2, "episode": 3, "warmup_steps": 1,
                                   "samples": 3, "trace_steps": 1}},
    "du_single.ctrl": {"traffic": {"warmup_steps": 1, "trace_steps": 1, "period_s": 0.01}},
}
