"""embeddingnet_tpu_torch — the PyTorch / CUDA port of ``embeddingnet_tpu``.

The JAX package beside it is the reference: every module here mirrors the
module of the same name there, and the tests run both on the same inputs.
This slice ports serving: uint8 images -> ResNet encoder -> L2-normalised
embedding -> kNN vote over the encodings DB, behind the micro-batching
:class:`embeddingnet_tpu_torch.serving.InferenceEngine`. The fused
BN-ReLU 3x3 conv of the ResNet's late stages is a CUDA kernel written for
Hopper (``csrc/fused_conv3x3.cu``).

Importing the package loads nothing heavy; import the submodules.
"""

__version__ = "0.1.0"
