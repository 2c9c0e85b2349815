"""Data-parallel training of the port: ranks and row blocks
(:mod:`.mesh`), the collectives with their gradients (:mod:`.collectives`),
the row-sharded miners (:mod:`.sharded`) and the sharded kNN
(:mod:`.sharded_knn`)."""
