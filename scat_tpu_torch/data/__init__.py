"""Datasets of the port: the synthetic task, STB with its preprocessing,
loader plumbing and native glue, the prefetcher and the stage mixes."""
