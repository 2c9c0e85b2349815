"""Host-side data helpers of the port: the dataset index, image decode and
P-K sampling."""

from embeddingnet_tpu_torch.data.index import ENDataLoader

__all__ = ["ENDataLoader"]
