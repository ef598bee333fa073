"""Weights: the flax-tree bridge and checkpoint loading."""
