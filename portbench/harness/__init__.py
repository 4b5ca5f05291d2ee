"""The benchmark's harness: finds a cell's configuration, traffic and
metrics by the names in ``BENCHMARK.json``, runs the cell's driver, and
prints the result line."""
