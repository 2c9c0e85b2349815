"""Training of the port: the triplet train step, its state and its
optimizer."""
