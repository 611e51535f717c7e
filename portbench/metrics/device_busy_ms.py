"""Milliseconds of device activity (the union of its intervals) in the
traced slice, over the slice's control steps."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("trace_steps") or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] * 1e3 / rec["trace_steps"]
