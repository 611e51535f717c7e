"""Device ms a step of the CBF-QP's rows and QP data (the port's
``cbf_qp.rows`` span: the DPCBF rows by their derivatives, the inert rows,
P, q, A and the bounds): the median over the traced slice's steps of the
time between the span's two CUDA events."""

from portbench.device_spans import span_device_ms


def read(rec):
    return span_device_ms(rec, "cbf_qp.rows")
