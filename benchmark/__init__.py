"""The benchmark of the PyTorch port: harness, plain reference, traffic
generator, metric readers, configuration and mix files (see run.py)."""
