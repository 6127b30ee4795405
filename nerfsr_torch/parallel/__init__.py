"""Data parallelism of the port (``mesh.py``)."""
