"""The mean of the port's ``controller.read`` spans in the traced slice
(ms): the one host read of a control step, which waits for the device."""

from portbench.program_trace import span_ms


def read(rec):
    return span_ms(rec, "controller.read")
