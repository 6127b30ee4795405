"""The plain reference that decides ``correct``: float32 PyTorch and
numpy, importing nothing of the system under test and no JAX."""
