"""Active constraint rows a Newton step a problem in the traced slice, as
B3 counted them (its phase clock's sum of each step's active rows over its
Newton steps)."""

from portbench.program_trace import b3_active_rows


def read(rec):
    return b3_active_rows(rec)
