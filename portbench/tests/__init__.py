"""CPU tests of the benchmark harness (card tests carry the ``cuda``
marker)."""
