"""B3's dual rollouts (the Jacobian columns), ms a launch: the share of
B3's blocks' cycles in that phase by its own phase clock, times its device
ms a launch in the traced slice."""

from portbench.program_trace import b3_phase_ms


def read(rec):
    return b3_phase_ms(rec, "jacobian")
