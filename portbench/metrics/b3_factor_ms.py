"""B3's Cholesky factor and its two substitutions, ms a launch: the
share of B3's blocks' cycles in those phases by its own phase clock, times
its device ms a launch in the traced slice."""

from portbench.program_trace import b3_phase_ms


def read(rec):
    return b3_phase_ms(rec, "factor")
