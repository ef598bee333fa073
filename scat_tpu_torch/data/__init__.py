"""Datasets of the port: the synthetic task, STB, FreiHAND, HO-3D, MHP and
RHD with their preprocessing, the folder-of-images test set, loader
plumbing and native glue, the prefetcher and the stage mixes."""
