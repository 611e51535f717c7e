"""Shielding: the port of ``safe_control_tpu/shielding/``."""
