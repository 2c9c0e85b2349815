"""Tensor ops of the port: distances, kNN and the fused small-spatial conv."""
