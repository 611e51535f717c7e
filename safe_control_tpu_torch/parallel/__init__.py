"""Parallel: the port of ``safe_control_tpu/parallel/``."""
