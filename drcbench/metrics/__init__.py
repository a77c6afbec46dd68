"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``value(run)`` gives the number, or None where the run holds nothing to
read."""
