"""Per-layer metrics, one file a metric, named as in ``BENCHMARK.json``;
``core.metric_reader`` loads each by its path (names hold dots)."""
