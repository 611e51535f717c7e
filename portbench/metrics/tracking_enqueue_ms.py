"""The port's first ``tracking.step`` span in the traced slice (ms): the
host's time to enqueue one fleet step.  The slice starts after a sync, so
that step's launches find the launch queue empty; later steps fill the
queue behind B3 and then wait inside a launch for room, so their spans time
B3, not the host."""

from portbench.program_trace import first_span_ms


def read(rec):
    return first_span_ms(rec, "tracking.step")
