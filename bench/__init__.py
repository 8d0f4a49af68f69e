"""The benchmark of the PyTorch port (``src/repro_torch``) on one H100."""
