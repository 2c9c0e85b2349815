"""Host-side data helpers of the port: the dataset index, image decode,
the samplers and the threaded batch loader."""

from embeddingnet_tpu_torch.data.index import ENDataLoader

__all__ = ["ENDataLoader"]
