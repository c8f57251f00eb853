"""One reader a metric, named as the metric: ``read(record)`` returns its
value, or None where the run has nothing to read it from (the harness
then leaves the metric out).  ``record`` is the dict that
``portbench.run.measure`` builds."""
