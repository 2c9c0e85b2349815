"""Parallel training of the port: ranks, the ``(data, model)`` grid and row
blocks (:mod:`.mesh`), the collectives with their gradients
(:mod:`.collectives`), the row-sharded miners (:mod:`.sharded`), the
sharded kNN (:mod:`.sharded_knn`), tensor parallelism over the model axis
(:mod:`.tp`) and the GPipe building block (:mod:`.pp`)."""
