"""The PyTorch port's benchmark: ``python3 -m portbench.run`` (see
``portbench/run.py``)."""
