"""Seconds from the process's start to the first timed step: imports, CUDA
initialisation, loading the kernels, the scene, the warm-up and any graph
capture (host clock)."""


def read(rec):
    return rec.get("setup_s")
