"""Training of the port: the triplet train and eval steps, their state and
optimizer, the callbacks, checkpoints and the ``Trainer`` loop."""
