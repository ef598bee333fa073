"""Datasets of the port (synthetic batches; real datasets follow)."""
