"""Models of the port: heads, ResNet backbones, the embedding module and the
high-level :class:`~embeddingnet_tpu_torch.models.api.EmbeddingNet`."""
