"""One reader a metric, ``<metric name>.py``, found by the name in
``BENCHMARK.json``: ``read(rec)`` takes the run's record and returns the
metric's value, or None when the run holds nothing for it to read."""
