"""B3's line search (Hs, the six candidates' rollouts, the merit, the
acceptance and the update), ms a launch: the share of B3's blocks' cycles
in that phase by its own phase clock, times its device ms a launch in the
traced slice."""

from portbench.program_trace import b3_phase_ms


def read(rec):
    return b3_phase_ms(rec, "linesearch")
