"""Tensor ops of the port: the attention kernel wrapper and geometry."""
