"""Metric readers, one module a metric of ``BENCHMARK.json``: each has
``read(ctx) -> float or None``.  ``ctx`` holds the driver's ``run``, the
``cell``, each feature's ``num_bins`` (the reference's) and the cell's
``precision``; a reader that finds nothing to read returns None and the
metric is left out of the result."""
