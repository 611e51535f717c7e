"""Envs: the port of ``safe_control_tpu/envs/``."""
