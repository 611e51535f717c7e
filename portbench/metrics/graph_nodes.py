"""Nodes of the captured control step's CUDA graph (the program's count)."""


def read(rec):
    n = rec.get("graph_nodes")
    return None if n is None else float(n)
