"""Utils: the port of ``safe_control_tpu/utils/``."""
