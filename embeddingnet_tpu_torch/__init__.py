"""embeddingnet_tpu_torch — the PyTorch / CUDA port of ``embeddingnet_tpu``.

The JAX package beside it is the reference: every module here mirrors the
module of the same name there, and the tests run both on the same inputs.
It covers serving (uint8 images -> ResNet encoder -> L2-normalised
embedding -> kNN vote over the encodings DB, behind the micro-batching
:class:`embeddingnet_tpu_torch.serving.InferenceEngine`), the triplet
training step with its augmentation, and the training loop
(:class:`embeddingnet_tpu_torch.train.loop.Trainer`: epochs, val, recall,
checkpoints and resume; ``tools/train_torch.py`` is its CLI). The small-map 3x3 convs of the
ResNet's late stages, forward and backward, and the conv with a BN-ReLU
epilogue are CUDA kernels written for Hopper, all in
``csrc/conv3x3_sm90.cu``.

Importing the package loads nothing heavy; import the submodules.
"""

__version__ = "0.1.0"
