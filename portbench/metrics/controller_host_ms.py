"""The mean over the port's ``controller.step`` spans in the traced slice
of their duration less their ``controller.read`` (ms): the host's own work
in a control step."""

from portbench.program_trace import self_ms


def read(rec):
    return self_ms(rec, "controller.step", "controller.read")
