"""Device ms a step of the work around B2 after its launch (the port's
``qp.finish`` span: the active-set polish, the unscaling and the
residuals): the median over the traced slice's steps of the time between
the span's two CUDA events."""

from portbench.device_spans import span_device_ms


def read(rec):
    return span_device_ms(rec, "qp.finish")
