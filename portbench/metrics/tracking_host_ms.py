"""Host milliseconds a step: the benchmark's own span around each call of
the cell's entry, without a synchronise, over the steps those calls ran.
Sound only where the host sets the pace."""


def read(rec):
    if not rec.get("host_steps"):
        return None
    return rec["host_s"] * 1e3 / rec["host_steps"]
