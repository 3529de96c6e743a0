"""The plain reference the benchmark judges the program against: PyTorch
and NumPy only, nothing of the program."""
