"""One module per metric, named as the metric is in ``BENCHMARK.json``:
``read(run)`` returns its value, or None when the run holds nothing to read
(the harness then leaves the metric out of the line). ``_count.py`` holds
the peaks and the operation and byte counts."""
