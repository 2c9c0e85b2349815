#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card: the serving path, the
T1 A/B tool, the triplet training step with and without augmentation, a
short flagship fit through the Trainer and its CLI, the step under every
mining mode, and a siamese fit, each through the hand-written kernels;
then the ViT/ArcFace path, which reaches T2 alone; then the EfficientNet
step and fit (T2 alone) and the inference tools (K3); then the
data-parallel step, remat and bf16 master weights; then the rest of the
backbone zoo and pretrained weights (the SE-ResNet-50 step through K1-K4);
then the native decoder, tensor parallelism on two ranks of the card (the
flagship through K1-K4), the GPipe block and the quickstart twin.

    python3 chip_smoke.py

1. Checks for a CUDA card (there is no CPU route) and prints its name and
   power limit as ``nvidia-smi`` reports them.
2. Builds the kernels: every ``embeddingnet_tpu_torch/csrc/*.cu`` with
   ``nvcc`` (one process per source, in parallel: the conv kernels and T2);
   prints ptxas's registers and spills for each kernel instance, and fails
   if any instance spills. Beside them it
   builds the native decoder (``csrc/enloader.cpp``, ``g++``); where the
   libjpeg/libpng headers are missing it prints ``native_decoder:
   unavailable: <the compiler's message>``, the decoder's documented
   behaviour (``BatchLoader``'s ``auto`` is then cv2).
3. Kernel phase: each kernel against its plain PyTorch version on the same
   inputs, in f32 with TF32 off, at the shapes ResNet-50 at 64x64 gives it
   (the forward K3/K1 at B = 3, 32, 256 and 1024, K1 at 8x8 too; the
   backward K1-as-dgrad, K2, K4 at B = 1024 and
   the conv kernels at B = 8 and the ragged B = 37, K2 at all three
   training shapes; T1, K1's forward with the affine-ReLU epilogue, at B =
   3, 128 and 1024 at S=2, C=512 and S=4, C=256, against the f32 and the
   bf16 plain version, and at B = 1024 bit for bit on exact integer inputs
   where an FMA would round otherwise), each check printed with its
   tolerance and its worst ratio to it. Times with CUDA events, against
   the plain version in bf16 and, where one PyTorch call computes the same
   function, against that call; where none does, against the eager
   sequence of library calls (``sequence_ms``: K3 ``_affine_relu`` then
   ``F.conv2d``, K4 ``_affine_relu`` then the weight-only
   ``convolution_backward``; T1 ``F.conv2d`` alone, ``conv2d_ms``, and the
   eager conv -> affine -> ReLU sequence, ``eager_sequence_ms``). At B =
   1024 the kernels, the library calls and the sequences are also timed by
   ``torch.profiler`` device time (``kernel_device_ms``,
   ``library_device_ms``, ``sequence_device_ms``, ``conv2d_device_ms``,
   ``eager_sequence_device_ms``), which a Python launch's host time does
   not inflate. T2, the normalisation, exact on all 256 u8 values, the
   training batch [1024, 64, 64, 3], a tail size and two misaligned views,
   then timed at the training batch beside ``torch.mul`` into bf16 four
   ways: CUDA events back to back (``ms``, L2-hot: the one input and the
   allocator's one output block stay in the 50 MB L2), profiler device
   time (``device_ms``, as hot), device time with L2 cold (``cold_ms``:
   64 MB written before each launch, the launch alone between two events)
   and the host's enqueue cost (``host_us``: 200 launches with no
   synchronize on the host clock). The attention kernels
   (``csrc/attention_sm90.cu``): the forward and dq, dk, dv against
   autograd of the float32 plain path (the plain path's errors in the
   input dtype beside them) and twice bit for bit, and the logsumexp and
   gradients against ``plain_forward_lse`` and ``plain_backward`` in
   float64, at the ViT-B/16 cell's core (B=256, N=197, h=12, d=64), N=50,
   N=257, N=1, B=3, h=6, d=32, d=128, fp16, and the float32 (d=40 too) and
   float64 instances; then at the cell's core timed forward and backward
   with CUDA events and profiler device time beside their bytes bounds,
   the plain bf16 path and ``F.scaled_dot_product_attention``
   (``library_*``, a yardstick the port never calls). ``python
   chip_smoke.py --attention`` builds and runs this part alone (about
   70 s); ``python chip_smoke.py --vit`` this part, phase 12 and phase
   16's (b) ViT and (c) pipeline, then the attention kernels' lines.
4. Serving phase: the flagship model (ResNet-50 v1.5, 64x64x3, 256-d
   L2-normalised embedding, kNN k=5, bf16, fused BN-ReLU conv on), with
   seeded random weights, encodes a DB of 10,240 synthetic images
   (1,024 classes x 10) in batches of 256, saves and reloads it, and answers
   requests of 1, 32 and 100 decoded images through the micro-batching
   engine. The answers are checked against a direct encode + kNN, against
   the true classes, and the embeddings against the cuDNN path.
5. Epilogue A/B phase: ``tools/fused_conv_epilogue_torch.py`` (the port
   of ``tools/pallas_fused_conv.py``) at B = 1024 under ``torch.profiler``:
   its numerics check and three interleaved timings of the library
   sequence and T1; the profiler must see one T1 kernel instance per
   launch and no K3.
6. Augmentation check: each op of the four presets on the card against the
   same op on the CPU from the same draws, to 1e-3 gray levels, and the
   ``default`` preset chained, where CLAHE pixels whose bin flips between
   the two are counted (at most 0.1%).
7. Training phase, augmentation off: the flagship triplet step (ResNet-50 as above,
   bn_momentum 0.9, batch-all mining with margin 0.5 on P-K batches of
   256 classes x 4 drawn by ``PKSampler`` from the serving DB's images,
   Adam at 1e-3 with step decay 0.99 per 500 steps, bf16, fused conv on),
   through ``TrainState.create`` and ``make_triplet_train_step``: 3 warm-up
   steps, then 10 timed steps with exact launch counts, finite and falling
   loss; one step from the same weights and batch on the cuDNN path must
   agree on the loss and the gradients; the cuDNN path's step time; the
   device-busy share from ``torch.profiler``; peak memory.
8. Training phase with the config's ``default`` augmentation (the flagship
   as ``configs/resnet50_batchall_1024.yml`` sets it), on 10,240 images of
   1,024 classes each laid out as 8x8 cells of colour: 3 warm-up and 20
   timed steps with exact launch counts (no T2: the augmented step divides
   in f32), finite and falling loss, the busy share, peak memory and the
   augmentation's device time per step (``torch.profiler``, the step's
   ``augment`` span, a profiler range by that name).
9. Fit phase: the flagship config (``configs/resnet50_batchall_1024.yml``,
   parsed by the port's ``parse_params``) fitted through the port's
   ``Trainer`` on a folder dataset written with cv2 (1,024 classes x 10
   PNGs of 8x8 colour cells), cut to 2 epochs of 4 steps and 2 val
   batches, recall every epoch, ``pallas_conv`` on (each cut printed as a
   ``reduced`` line): finite train and val losses, recall@1/@5 in [0, 1],
   exact launch counts of K1-dgrad, K2, K3, K4 and T2 over the fit (the
   train steps, the val epochs' forwards of 3 x 1,024 images and the
   recall evals' 256-image chunks), the best epoch's checkpoint; a second
   ``Trainer`` resumes epoch 0 and holds the saved module, optimizer,
   generator, step and plateau scale bit for bit; the CLI
   (``tools/train_torch.py --resume_from latest``) fits what is left and
   exports, and its base model, reloaded by ``EmbeddingNet.load_model``,
   encodes 256 images within bf16 2e-2 of its Trainer's encoder. Prints
   each epoch's wall time and parts, the Trainer's ``images_per_sec``
   beside phase 8's bare step, the checkpoint's size and save time.
10. Mining phase: phase 8's step (ResNet-50, the ``default`` augmentation,
    its images) under each mining mode on each of its paths: at B = 1024
    on grouped P-K batches batch-all (the yardstick), semihard, hardest,
    random_hard and batch_hard; at B = 256 the three reference modes on
    the [B, B, B] enumeration; at B = 1024 with the rows shuffled out of
    their groups the three on the dense rank-window path. Each: 2 warm-up
    and 10 timed steps with exact launch counts (phase 8's per step), the
    step median and spread, images/s, the miner's device time alone
    (forward and backward on the step's embeddings, ``torch.profiler``),
    ``n_triplets`` and ``frac_mined``. Then every mode on each path on the
    card against the port's CPU run, on one fixed batch of embeddings
    whose squared distances are exact in f32, with the same draws:
    identical selections, loss, stats and gradient within 1e-5. Then the
    flagship config fitted 2 epochs of 2 steps at phase 9's other cuts
    with one semihard warm-up epoch before batch_hard: the Trainer must log
    the switch at epoch 1.
11. Siamese phase: ``configs/siamese_resnet18_pairs.yml`` (ResNet-18, l2
    distance, contrastive loss, radam, pairs of ``PairSampler``) parsed by
    ``parse_params`` and fitted through the ``Trainer`` on 1,280 PNGs of
    128 classes, each cut printed as a ``reduced`` line (``n_epochs`` 2,
    ``n_batches`` 16, ``compute_dtype`` bf16 and ``pallas_conv`` on so the
    kernels run, no plots, a temp dir): loss and accuracy per epoch, exact
    launches of K1's forward, the dgrad, K2, K3, K4 and T2 predicted from
    the gate (``SIAMESE_PER_STEP``), a second Trainer's ``resume(0)`` bit
    for bit, and the CLI's resume and export.
12. ViT/ArcFace phase: (a) ``configs/vit_arcface.yml``'s step at full
    width and depth (ViT-B/16, 224 px, 512-d, B=256, Adam with its warm-up
    schedule, EMA, the ``deepfake`` flip, bf16, random weights from the
    seed) on colour-cell images of 1,000 classes: 3 warm-up and 10 timed
    steps (median, images/s, peak memory, every port kernel's launches at
    0), then 2 under ``torch.profiler``: device time, busy share, the top
    ops and kernels, and the shares of attention's products and softmax,
    of LayerNorm and the activations and of all matmuls; (b) the same for
    ``configs/clip_vitl14_arcface.yml`` (the CLIP ViT-L/14 tower, B=32,
    AdamW), 2 warm-up and 5 timed steps; (c) small ViTs of both families
    under an ArcFace module, f32 with TF32 off, on the card (the attention
    kernels' float32 instances) against the CPU: embeddings, loss and
    every gradient within 1e-5; (d)
    ``configs/vit_arcface_smoke.yml`` fitted through the ``Trainer`` on
    107 classes x 40 PNGs at 96 px after a ``SOFTMAX_PRETRAINING`` epoch
    of 4 steps and 2 val steps (cuts and settings printed), which must log
    its handoff: loss, recall and wall per epoch, T2's launches exact (the
    pretraining's val batches), every other kernel at 0; (e) a second
    Trainer's ``resume(0)`` bit for bit, and the CLI's resume and export.
    On (a), (b), (c) and (d), and on phase 16's (b) ViT steps and (c)
    pipeline, the attention launches are exact: one forward launch a core
    call on the card, one backward a differentiated call, no plain call
    on the card.
13. Depthwise phase: (a) ``configs/efficientnetb3_batchhard_1024.yml``'s
    step at full width and depth (EfficientNet-B3 at 96 px, 256-d, L2
    norm, B=1,024 as P-K 256 x 4, bf16, bn_momentum 0.9, the ``default``
    augmentation, batch_hard, Adam 1e-3 with its warm-up schedule,
    drop-connect drawn from the state's generator) on colour-cell images
    of 1,024 classes: 3 warm-up and 10 timed steps (median, images/s, peak
    memory, every port kernel's launches at 0), 2 under ``torch.profiler``
    (device time, busy share, the depthwise convs forward and backward by
    kernel name apart from the other convs, BatchNorm's eager ops, SiLU and
    sigmoid, copies, the top ops and kernels), the miner alone, and one
    semihard step (the config's warm-up mode); (b) small EfficientNet,
    MobileNet v1/v2, ``simple`` and ``simple2`` models on the card against
    the CPU from one state_dict, the CPU run's drop masks fed to the card:
    in float64 train mode the embeddings, the triplet loss and every
    gradient, in f32 eval mode with TF32 off the embeddings, to 1e-5
    (``CARD_FAMILIES`` says why float64); (c) ``configs/road_signs_tpu.yml``
    (EfficientNet-B1 at 48 px, semihard, radam) fitted through the
    ``Trainer`` on a CSV index (``file_path``/``class_name``) of 400
    colour-cell PNGs of 40 classes, cut to 2 epochs of 8 steps (each cut a
    ``reduced`` line): finite losses, T2's launches exact (the val
    batches) and every other kernel at 0, T2 against its plain version at
    the val batches' shape, a second Trainer's ``resume(0)`` bit for bit;
    (d) on phase 9's CLI export (ResNet-50, ``pallas_conv`` on, bf16):
    ``encode_dataset`` over its 10,240 PNGs (images/s), the evaluate CLI's
    recall equal to ``calculate_prediction_accuracy``, the test CLI's label
    equal to ``predict_knn``, the ``.pt2`` reloaded on the card within bf16
    rounding of the module, K3's launches exact over all of it, and K3
    against its plain version at the test CLI's B = 1.
14. Data-parallel phase: (a) ``configs/batch4096_sharded.yml``'s step at
    full width and global batch (ResNet-50 at 64 px, 256-d, B=4,096 as P-K
    1,024 x 4, bf16, batch-all, the ``default`` preset, Adam 2e-3 with its
    warm-up, bn_momentum 0.9, random weights from seed 0, colour cells of
    1,024 classes) through the data-parallel step in an NCCL group of one
    rank (global BatchNorm, the row-sharded miner, the gradient
    all-reduce: the collectives run), remat on and off: median of 10 steps
    after 3, images/s, device time and busy share, peak memory, the
    sharded miner's device time alone, the collectives' device time;
    remat must lower the peak; (b) the flagship step (``pallas_conv`` on)
    with remat against without, from the same state and batch: float64 to
    1e-12, bf16 with K1-K4 under the recompute to stated bounds, their
    launches exact (K3 twice a fused conv); (c) the config fitted through
    ``torchrun --nproc_per_node=1`` and the train CLI (this script's
    ``--fit-child`` mode runs the CLI's ``main`` on the rank), cut (each
    cut a ``reduced`` line) on phase 9's PNGs: T2's launches exact, the
    recall through the sharded kNN equal to the plain kNN's, and a second
    torchrun run resumed from epoch 0 ending bit for bit where the straight
    run ended; (d) one flagship step with bf16 master weights: every tensor
    and the optimizer's moments bf16, the loss finite.
15. Zoo phase: (a) ``configs/resnet50_batchall_1024.yml`` with
    ``backbone_name: seresnet50`` and ``backbone_weights: 'imagenet'``,
    which resolves through ``$EMBEDDINGNET_WEIGHTS_DIR`` to a ``.npz`` of
    a seeded port model's backbone: the Trainer built on the card (the
    backbone equal to the file bit for bit, the head to its fresh
    initialisation), then its step (B=1,024, bf16, the ``default``
    augmentation, ``pallas_conv`` on) on colour-cell P-K batches: 3
    warm-up and 10 timed steps with the ResNet-50 step's exact launches
    of K1-as-dgrad, K2, K3 and K4, a falling loss, CUDA-event median,
    images/s, peak memory, then 2 under ``torch.profiler`` (device time,
    busy share); (b) one name per zoo family at its smallest input
    (SE-ResNet-18, SE-ResNeXt-50, SENet-154, DenseNet-121 and VGG-16 at
    32 px, the Inceptions at 75, Xception at 71, NASNet-Mobile at 32 and
    33) on the card against the CPU from one state_dict in float64 train
    mode: the embeddings, the batch-hard loss and every gradient to 1e-5;
    (c) ``configs/vit_arcface_smoke.yml`` on DenseNet-121 from a weights
    preset (loaded into the arcface module's encoder), fitted 2 epochs of
    4 steps on 256 PNGs at 96 px (cuts printed), every kernel at 0
    launches, a second Trainer's ``resume(0)`` bit for bit; (d) each of
    the 20 names this slice ported, an eval forward in bf16 at B=32 at
    its native input (224 px; the Inceptions and Xception 299, NASNet-Large
    331): ms a forward and peak memory.
16. Phase 16: (a) the native decoder on phase 9's 10,240 PNGs and 512
    seeded JPEGs (256 px, quality 90) to 64 px: img/s natively (exact and
    fast) and with cv2 on 8 threads, the exact path's largest difference
    from cv2 (at most 1 level), the fast path's mean and p99; then phase
    9's fit and phase 13 (d)'s ``encode_dataset`` on it beside their cv2
    numbers. Without the libraries: the ``unavailable`` line, cv2's rate,
    and ``auto`` asserted to resolve to cv2. (b) Tensor parallelism over
    two gloo ranks of the card (``torchrun --nproc_per_node=2``, NCCL
    refuses two ranks on one device): ``configs/vit_arcface.yml``
    (ViT-B/16, 224 px, B=256, ArcFace, bf16, TF32 off) at ``MESH.model:
    2``, its first step against the one-process step from the same weights
    and batch (loss, gradient, parameters after it, each within the
    limits printed), then 3 timed steps and each rank's peak; and
    ``configs/resnet50_batchall_1024.yml`` at ``MESH.model: 2`` with
    ``pallas_conv`` through the Trainer, 2 steps: each rank's launches
    exactly phase 8's per step, equal on both. (c) GPipe over the two
    ranks: ViT-B/16's 12 blocks, 2 stages, 4 microbatches, B=32, bf16,
    output and each stage's gradient against the blocks in order. (d)
    ``examples/quickstart_torch.py`` on the card, end to end.

The last line of standard output is the result,
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit. The line before that lists each kernel: its launches
during the run of its path (the augmented training run for the conv
kernels, K3 also during the serving run; the aug-off training run for T2;
the A/B tool's run for T1; phase 11's siamese fit for K1's forward) and
its launches over phase 9's fit (``fit_launches``), phase 11's
(``siamese_fit_launches``), phase 12's (``vit_fit_launches``), phase 13's
road-signs fit (``road_signs_fit_launches``), inference tools
(``inference_launches``), phase 14's runs (``phase14_launches``: (a)'s
timed sharded steps, (b)'s remat step, (c)'s fit) and phase 15's
(``phase15_launches``: (a)'s timed SE-ResNet-50 steps, (c)'s fit, (d)'s
forwards) and phase 16's (``phase16_launches``: each rank of (b)'s
ResNet run, and (a)'s native fit where the decoder builds), its
worst error, and ``ms`` / ``plain_ms`` /
``bound_ms`` / ``library_ms``, the event time of the kernel, its plain
version, the card's bound and the library call, summed over the calls one
training step makes at B = 1024 (T1: one call at B = 1024, S = 2, C = 512;
K1's forward: the calls of one siamese step, two streams of B = 8),
with the device-time keys of phase 3 summed alike; K3's serving numbers
(per B=32 forward) are under ``serve``; K1 as the dgrad and K2 add
``library_ratio``, their ``ms`` over ``library_ms``, and
``library_ratio_device``, ``kernel_device_ms`` over ``library_device_ms``;
K3 and K4 add ``sequence_ms``; the conv kernels add ``device_ms``, their
``torch.profiler`` device time per augmented step (the part sums apart, in
``training_step_part_sums_ms``; T1: per launch in the A/B tool's run);
the attention kernels' entries give their launches on each ViT path
(``launches``, by path, ``plain_launches`` beside them) and their times
summed over one step of the benchmark cell vit-b16-arcface-train (24
forward, 12 backward calls at its core); ``mining`` holds phase 10's rows.
Any failure raises, and the script exits non-zero without the last
line.
"""

import functools
import json
import os
import re
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.data.samplers import PKSampler
from embeddingnet_tpu_torch.models.api import EmbeddingNet
from embeddingnet_tpu_torch.models.registry import EmbeddingModule
from embeddingnet_tpu_torch.ops import _cuda
from embeddingnet_tpu_torch.ops import attention as att
from embeddingnet_tpu_torch.ops import augment as aug
from embeddingnet_tpu_torch.ops import batchnorm as bnk
from embeddingnet_tpu_torch.ops import fused_conv as fc
from embeddingnet_tpu_torch.ops import preprocess as pre
from embeddingnet_tpu_torch.ops.knn import knn_classify
from embeddingnet_tpu_torch.parallel.tp import shard_module
from embeddingnet_tpu_torch.serving import InferenceEngine
from embeddingnet_tpu_torch.train.optim import (get_optimizer,
                                                step_decay_schedule)
from embeddingnet_tpu_torch.train.state import TrainState
from embeddingnet_tpu_torch.train.steps import make_triplet_train_step

SEED = 0
DEVICE = "cuda"
SM90_SRC = "embeddingnet_tpu_torch/csrc/conv3x3_sm90.cu"
T2_SRC = "embeddingnet_tpu_torch/csrc/normalize_u8_sm90.cu"
BN_SRC = "embeddingnet_tpu_torch/csrc/batchnorm_sm90.cu"
ATT_SRC = "embeddingnet_tpu_torch/csrc/attention_sm90.cu"
JAX_CONV = "embeddingnet_tpu/ops/fused_conv.py"
# phase 9's fit and phase 13 (d)'s encode as they decoded (phase 16 (a)
# prints the native decoder's beside them)
CV2_NUMBERS = {}
# name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "conv3x3_small_bn_relu": ("cuda", SM90_SRC, f"{JAX_CONV}:556"),
    "conv3x3_dgrad": ("cuda", SM90_SRC, f"{JAX_CONV}:200"),
    "conv3x3_wgrad": ("cuda", SM90_SRC, f"{JAX_CONV}:225"),
    "conv3x3_wgrad_bn_relu": ("cuda", SM90_SRC, f"{JAX_CONV}:575"),
    "normalize_u8": ("cuda", T2_SRC, "tools/perf_probe3.py:63"),
    "conv3x3_small_affine_relu": ("cuda", SM90_SRC,
                                  "tools/pallas_fused_conv.py:39"),
    # K1's forward: ResNet-50 does not reach it (its stride-1 3x3 convs all
    # follow a BatchNorm, so all are fused); ResNet-18's second block of a
    # stage does (conv1), so its path is phase 11's siamese fit
    "conv3x3_small": ("cuda", SM90_SRC, f"{JAX_CONV}:200"),
    # BatchNorm: no TPU kernel (XLA fuses it into the convs); they replace
    # the port's eager BatchNorm
    **{name: ("cuda", BN_SRC, "ops/batchnorm.py plain_scale_bias, "
              "plain_batch_norm") for name in bnk.LAUNCHES},
    # attention: no TPU kernel (Flax's MultiHeadDotProductAttention, which
    # XLA fuses; no pallas_call); they replace the port's eager core
    **{f"attention_{role}": ("cuda", ATT_SRC, "ops/attention.py "
                             "plain_attention") for role in ("fwd", "bwd")},
}
# the attention kernels' calls in one step of the benchmark cell
# vit-b16-arcface-train (12 blocks; remat runs each forward twice), over
# which the kernels line sums their times
ATT_STEP_CALLS = {"fwd": 24, "bwd": 12}
# the attention launches of each ViT path the smoke drives, by path
ATT_LAUNCHES = {}
# the kernels whose per-step time is held to one library call's
# (kernel ms / library ms in the kernels line)
LIBRARY_RATIO = ("conv3x3_dgrad", "conv3x3_wgrad")
# each conv kernel's instances in torch.profiler's kernel names
# (conv3x3_sm90_kernel<dgrad, rows, prologue, epilogue>); K2's and K4's part
# sums share one kernel
PROFILED_NAMES = {
    "conv3x3_small_bn_relu": ("conv3x3_sm90_kernel<false,", ", true, false>"),
    "conv3x3_dgrad": ("conv3x3_sm90_kernel<true,",),
    "conv3x3_wgrad": ("conv3x3_wgrad_sm90_kernel<false>",),
    "conv3x3_wgrad_bn_relu": ("conv3x3_wgrad_sm90_kernel<true>",),
    "conv3x3_small_affine_relu": ("conv3x3_sm90_kernel<false,",
                                  ", false, true>"),
}
PART_SUM_NAME = "conv3x3_sum_parts_kernel"
# T1's path: the A/B tool at its own batch, stage 4's shape
TOOL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                    "fused_conv_epilogue_torch.py")
TOOL_BATCH, TOOL_S, TOOL_C = 1024, 2, 512
# the conv kernels' A/B tool, whose profiler timing T2's device time uses
AB_TOOL = os.path.join(os.path.dirname(TOOL), "conv3x3_kernels_ab_torch.py")
EPILOGUE_SHAPES = [(2, 512), (4, 256)]
EPILOGUE_BATCHES = [3, 128, TOOL_BATCH]
# kernels that ResNet-50's training path never launches
RESNET50_OFF_PATH = ("conv3x3_small", "conv3x3_small_affine_relu")
# ResNet-50 at 64x64: (S, C, stride-1 3x3 convs per forward). Stage 2's
# blocks 2-4 run the mixed op at 8x8 (cuDNN forward, K1-dgrad + K2), stages
# 3 and 4 the fused op (K3, K1-dgrad + K4).
MIXED_SHAPES = [(8, 128, 3)]
FUSED_SHAPES = [(4, 256, 5), (2, 512, 2)]
SERVE_BATCHES = [3, 32, 256]
SIAMESE_BATCH = 8   # the siamese config's pairs per step: B of each stream
TRAIN_BATCH = 1024
SMALL_BATCH = 8     # JAX's 8x8 gate needs a multiple of 8
RAGGED_BATCH = 37   # fills no 128-row tile and no 64-position chunk
# per training step at B = 1024: kernel -> [(S, C, calls)]
PER_STEP = {
    "conv3x3_small_bn_relu": FUSED_SHAPES,
    "conv3x3_dgrad": MIXED_SHAPES + FUSED_SHAPES,
    "conv3x3_wgrad": MIXED_SHAPES,
    "conv3x3_wgrad_bn_relu": FUSED_SHAPES,
}
EXPECTED_PER_STEP = {name: sum(n for _, _, n in shapes)
                     for name, shapes in PER_STEP.items()}
EXPECTED_PER_STEP["normalize_u8"] = 1
# with augmentation the step divides in f32 after it, as JAX does: no T2
EXPECTED_AUG_PER_STEP = {**EXPECTED_PER_STEP, "normalize_u8": 0}
# bf16 output rounding: the JAX package's bf16 bound for these kernels
# (tests/test_fused_conv.py, test_forward_bf16)
RTOL = ATOL = 2e-2
# the f32 weight gradient: the same bf16 products summed in f32 in another
# order, to 1e-3 of the largest entry
WGRAD_REL = 1e-3
# H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# T2's edge checks: a size with a tail of n % 16 = 3, taken from the start
# of a flat tensor and at offsets 1 (the scalar path) and 8 (an 8-element
# head); its cold reading writes FLUSH_BYTES, more than the 50 MB L2,
# before each launch; its host reading enqueues HOST_LAUNCHES launches
T2_TAIL = 1_000_003
FLUSH_BYTES = 64 << 20
HOST_LAUNCHES = 200
SLEEP_CYCLES_PER_ITER = 200_000     # ~100 us at the H100's ~2 GHz

FLAGSHIP = {
    "model": {"backbone_name": "resnet50", "input_shape": [64, 64, 3],
              "encodings_len": 256, "embeddings_normalization": True,
              "mode": "triplet"},
    "general": {"seed": SEED},
    "encodings": {"knn_k": 5},
    "generator": {"augmentations": "default"},
}
N_CLASSES, PER_CLASS, DB_BATCH, MAX_BATCH = 1024, 10, 256, 32
NOISE = 8   # gray levels of per-image noise around each class's base image
# The augmented training phase's class images: 8x8 cells of one random
# colour each (a class is a layout of coloured regions). The serving DB's
# uniform-noise classes carry their identity in pixel detail only, which the
# preset's brightness, contrast, gamma, HSV and noise ops swamp for a net at
# initialisation (tools/augment_probe_torch.py: no separation in 40 steps).
CELLS = 8

# the training phases (configs/resnet50_batchall_1024.yml), augmentation
# off and with the config's preset
P_CLASSES, K_SAMPLES = 256, 4
MARGIN, LR, LR_DECAY, STEPS_PER_EPOCH = 0.5, 1e-3, 0.99, 500
BN_MOMENTUM = 0.9
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS, CUDNN_STEPS = 3, 10, 3, 5
AUG_PRESET, AUG_TIMED_STEPS = FLAGSHIP["generator"]["augmentations"], 20
# augmentation on the card against the CPU, from the same draws: the same
# f32 ops, whose pow, division and sums round differently on the two (1e-3
# gray levels of 0..255); chained, a CLAHE pixel whose luminance lands on
# the other side of a bin edge maps elsewhere: at most 0.1% of the pixels
AUG_CHECK_BATCH, AUG_ATOL, AUG_FLIP_SHARE = 128, 1e-3, 1e-3
# One step from the same weights and batch through the kernel path and the
# cuDNN path, both bf16, and the cuDNN path in f32 as the reference: the
# two bf16 losses within 2e-2 relative of each other; the kernel path's
# gradient no further from the f32 gradient (relative L2) than GRAD_FACTOR
# times the cuDNN path's, over all parameters together, and for each conv
# weight no further than GRAD_FACTOR times the cuDNN path's plus
# GRAD_SLACK. Two bf16 implementations round at other places, and batch-all
# mining turns a rounding at a hinge's edge into a triplet in or out.
LOSS_RTOL, GRAD_FACTOR, GRAD_SLACK = 2e-2, 1.5, 0.05

# the fit phase: the flagship config fitted through the Trainer, with these
# cuts: (section, key, value, why); dataset_path and work_dir are set to
# the phase's temp dir
FIT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "resnet50_batchall_1024.yml")
TRAIN_CLI = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "train_torch.py")
FIT_CLASSES, FIT_PER_CLASS = 1024, 10
FIT_CUTS = [
    ("DATALOADER", "dataset_path", None, "no data on the machine"),
    ("GENERATOR", "n_batches", 4, "run time"),
    ("GENERATOR", "n_batches_val", 2, "run time"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("TRAIN", "eval_recall_every", 1, "so recall runs"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]

# phase 10: the mining modes on the flagship step (phase 8's step, its
# augmentation and images). (path, B, whether the batch keeps the grouped
# P-K layout, modes): the grouped P-K paths at B=1024 (batch_all the
# yardstick), the [B, B, B] enumeration at B=256, and at B=1024 the dense
# rank-window path on rows shuffled out of their groups
PARITY_MODES = ("semihard", "hardest", "random_hard")
MINING_RUNS = [("pk", TRAIN_BATCH, True, ("batch_all",) + PARITY_MODES
                + ("batch_hard",)),
               ("enumeration", 256, True, PARITY_MODES),
               ("dense", TRAIN_BATCH, False, PARITY_MODES)]
MINING_WARMUP, MINING_TIMED = 2, 10
# the miner on the card against its CPU run, on exact distances (the
# embeddings on a grid where every product and partial sum of the squared
# distances is exact in f32) and the same draws: identical selections; the
# loss and the stats, sums in another order, to 1e-5 relative; the
# gradient, products with 1/n_selected, to 1e-5 of its largest entry
MINING_RTOL = 1e-5
# the warm-up fit: phase 9's cuts at 2 steps an epoch, and the warm-up
WARMUP_FIT_CUTS = [(s, k, 2 if k == "n_batches" else v, why)
                   for s, k, v, why in FIT_CUTS]
WARMUP_FIT_SETTINGS = [("TRAIN", "mining_warmup_epochs", 1),
                       ("TRAIN", "mining_warmup_mode", "semihard"),
                       ("GENERATOR", "negatives_selection_mode",
                        "batch_hard")]
WARMUP_SWITCH = ("epoch 1: mining mode semihard -> batch_hard "
                 "(TRAIN.mining_warmup_epochs=1)")

# phase 11: configs/siamese_resnet18_pairs.yml fitted through the Trainer
SIAMESE_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG),
                              "siamese_resnet18_pairs.yml")
SIAMESE_CLASSES, SIAMESE_STEPS = 128, 16
SIAMESE_CUTS = [
    ("DATALOADER", "dataset_path", None, "no data on the machine"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", SIAMESE_STEPS, "run time"),
    ("PERFORMANCE", "compute_dtype", "bfloat16", "the kernels take bf16; "
     "the gate sends f32 to F.conv2d"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]
# ResNet-18 at 64x64 has its stride-1 3x3 convs at 8x8x128 (stage 2: block
# 1's conv2, block 2's conv1 and conv2) and at 4x4x256 and 2x2x512 (stages
# 3 and 4 alike). At 8x8 all three take the mixed op (the cuDNN forward;
# backward K1-dgrad + K2: a stream of 8 passes the JAX batch-tile gate); at
# 4x4 and 2x2 each stage's two conv2s are fused (K3; backward K1-dgrad +
# K4) and block 2's conv1 is K1's forward (backward K1-dgrad + K2). So one
# stream's forward launches K1 2 and K3 4 times, its backward the dgrad
# 3 + 3 + 3, K2 3 + 1 + 1 and K4 2 + 2 times; a siamese train step runs two
# streams and divides in f32 after its augmentation (no T2); a val step's
# two eval forwards divide the uint8 batches by T2.
SIAMESE_PER_STEP = {"conv3x3_small": 4, "conv3x3_small_bn_relu": 8,
                    "conv3x3_dgrad": 18, "conv3x3_wgrad": 10,
                    "conv3x3_wgrad_bn_relu": 8}
SIAMESE_PER_VAL = {"conv3x3_small": 4, "conv3x3_small_bn_relu": 8,
                   "normalize_u8": 2}
# K1's forward calls per siamese train step: (S, C, calls)
SIAMESE_K1_SHAPES = [(4, 256, 2), (2, 512, 2)]

# phase 12: the ViT/ArcFace path. (a) configs/vit_arcface.yml's step at
# full width and depth, (b) configs/clip_vitl14_arcface.yml's, both on
# synthetic colour-cell images of VIT_CLASSES classes; (c) small ViTs of
# both families and the ArcFace loss on the card against the CPU; (d)
# configs/vit_arcface_smoke.yml fitted through the Trainer with a softmax
# pretraining phase, (e) its resume and CLI
VIT_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG), "vit_arcface.yml")
CLIP_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG),
                           "clip_vitl14_arcface.yml")
VIT_SMOKE_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG),
                                "vit_arcface_smoke.yml")
VIT_CLASSES, VIT_POOL = 1000, 1024
VIT_WARMUP, VIT_TIMED, CLIP_WARMUP, CLIP_TIMED, VIT_PROFILED = 3, 10, 2, 5, 2
# device time by aten op: attention's core (its score and value products,
# the only batched matmuls of a ViT, and the softmax, forward and
# backward); LayerNorm and the activations (quick-GELU's sigmoid counted,
# its product not); every matmul; the copies (dtype casts, and the heads'
# transposes made contiguous)
VIT_SHARES = {
    "attention": ("aten::bmm", "aten::_softmax",
                  "aten::_softmax_backward_data"),
    "norm_act": ("aten::native_layer_norm", "aten::native_layer_norm_backward",
                 "aten::gelu", "aten::gelu_backward", "aten::sigmoid",
                 "aten::sigmoid_backward"),
    "matmul": ("aten::mm", "aten::addmm", "aten::bmm"),
    "copy": ("aten::copy_",),
}
# (c): small ViTs of each family (the registry names' entries replaced),
# f32 with TF32 off, card against CPU from the same weights and images: the
# embeddings, the ArcFace loss and every gradient to VIT_CARD_TOL of the
# tensor's largest entry (sums in another order); the key biases, whose
# gradient is zero in exact arithmetic, to VIT_CARD_TOL of the model's
# largest gradient entry
VIT_SMALL = {"vit-b16": dict(patch=16, dim=128, depth=2, heads=4),
             "vit-l14": dict(patch=16, dim=128, depth=2, heads=4,
                             ln_pre=True, use_quick_gelu=True,
                             patch_bias=False, proj_dim=96, ln_eps=1e-5)}
VIT_CARD_TOL = 1e-5
# (d): the smoke config's dataset (its comment: 107 classes x 40 PNGs at
# 96 px), its cuts and the pretraining phase it is given
VIT_FIT_CLASSES, VIT_FIT_PER_CLASS, VIT_FIT_SIZE = 107, 40, 96
VIT_FIT_CUTS = [
    ("DATALOADER", "dataset_path", None, "no data on the machine"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", 8, "run time"),
    ("TRAIN", "eval_recall_every", 1, "so recall runs every epoch"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]
VIT_FIT_SETTINGS = [("SOFTMAX_PRETRAINING", "n_epochs", 1),
                    ("SOFTMAX_PRETRAINING", "steps_per_epoch", 4),
                    ("SOFTMAX_PRETRAINING", "val_steps", 2),
                    ("SOFTMAX_PRETRAINING", "batch_size", 128)]
HANDOFF_LOG = "handed to the model's encoder.backbone"


@functools.lru_cache(maxsize=None)
def _ab_tool():
    return runpy.run_path(AB_TOOL)


def device_ms(fn):
    """Device time of one call of ``fn``: torch.profiler's kernel time, as
    the conv kernels' A/B tool measures it."""
    return _ab_tool()["device_ms"](fn)


def _profile_agreed(run, what):
    """torch.profiler (the CPU and CUDA activity) over ``run()``: ``(prof,
    kernels, wall seconds)`` of a read that the A/B tool's ``settled``
    takes (F15: the profiler loses kernel records now and then), reading
    ``run`` again up to its ``READS`` times, as its ``device_ms`` does;
    else AssertionError naming ``what``."""
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(_ab_tool()["READS"]):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device activity: kernels, copies and sets, not the annotations
        # that span them on the device's timeline
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        counts.append(len(kernels))
        if _ab_tool()["settled"](counts):
            return prof, kernels, wall
    raise AssertionError(f"{what}: no two torch.profiler reads saw the most "
                         f"CUDA kernels (reads of {counts})")


def _run_steps(state, step, batches):
    """A callable that takes one step on each of ``batches``."""
    def run():
        for images, labels in batches:
            step(state, images, labels)
    return run


def cuda_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    """(ms, what bounds it): the least time the card could take for
    ``flops`` bf16 operations moving ``nbytes``."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def conv_cost(name, b, s, c):
    """(FLOPs, bytes) of one call of a conv kernel at [b, s, s, c], c -> c:
    each input read once, each output written once."""
    flops = 2 * b * s * s * 9 * c * c
    act = b * s * s * c * 2                       # a bf16 activation
    weight = 9 * c * c * 2                        # a bf16 weight
    affine = 2 * c * 4                            # f32 scale and bias
    nbytes = {
        "conv3x3_small": 2 * act + weight,
        "conv3x3_small_bn_relu": 2 * act + weight + affine,
        "conv3x3_dgrad": 2 * act + weight,
        "conv3x3_wgrad": 2 * act + 2 * weight,    # f32 dW
        "conv3x3_wgrad_bn_relu": 2 * act + 2 * weight + affine,
        "conv3x3_small_affine_relu": 2 * act + weight + affine,
    }[name]
    return flops, nbytes


def check_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card; the port has no CPU "
                         "route to smoke-test")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    return smi


def build():
    """Every kernel's library (one nvcc per source, in parallel) and, on a
    thread beside them, the native decoder (g++): where the libjpeg/libpng
    headers are missing, its ``unavailable`` line, the documented
    behaviour; any other build failure raises."""
    import threading
    from embeddingnet_tpu_torch.data import native_loader
    t0 = time.perf_counter()
    native = {}

    def build_native():
        try:
            native["ok"] = native_loader.available()
        except BaseException as e:      # raised below, in this thread
            native["error"] = e
    thread = threading.Thread(target=build_native)
    thread.start()
    paths = _cuda.build()
    for source in _cuda.SOURCES:
        _cuda.library(source.stem)
    thread.join()
    if "error" in native:
        raise native["error"]
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    if native["ok"]:
        print(f"build: native decoder {native_loader.library_path().name}")
    else:
        print(f"native_decoder: unavailable: "
              f"{native_loader.unavailable_reason()}")
    spills = []
    for path in paths:
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        kernel = "?"
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = _kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {kernel}: "
                      f"{line.replace('ptxas info    :', '').strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and (int(m.group(1)) or int(m.group(2))):
                    spills.append(kernel)
    if spills:
        raise AssertionError(f"ptxas reports spills in {spills}")


def _kernel_label(mangled):
    """``conv3x3_sm90_kernel<false, 256, true>`` or
    ``normalize_u8_sm90_kernel`` from the mangled name of a kernel instance
    (bool and int template arguments)."""
    m = re.search(r"\d+((?:conv3x3|normalize_u8|bn|attention)_\w*?_kernel)"
                  r"(?:I((?:L[bi]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([bi])(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def _tensor(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()


def _affine(rng, c):
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)).cuda()
    bias = torch.from_numpy(
        (rng.normal(size=(c,)) * 0.1).astype(np.float32)).cuda()
    return scale, bias


def _check(label, got, want, atol, rtol):
    """Worst error of ``got`` against the f32 ``want`` and its ratio to
    ``atol + rtol * |want|``; raises past 1."""
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    max_err = err.max().item()
    worst = (err / (atol + rtol * want.abs())).max().item()
    print(f"check {label}: max_abs_err {max_err:.3e}, tolerance atol "
          f"{atol:.3e} + rtol {rtol:g} * |ref|, worst ratio {worst:.3f}")
    if not torch.isfinite(got).all() or worst > 1.0:
        raise AssertionError(f"{label}: max abs err {max_err} exceeds the "
                             f"tolerance (worst ratio {worst:.3f})")
    return max_err, worst


def _record(records, name, row):
    rec = records.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
    rec["shapes"].append(row)
    rec["max_abs_err"] = max(rec["max_abs_err"], row["max_abs_err"])


def forward_kernel_phase(records):
    """K3 and K1's forward against their plain version, at the serving
    batches and the training batch."""
    rng = np.random.default_rng(SEED)
    for s, c, _ in MIXED_SHAPES + FUSED_SHAPES:
        w32 = _tensor(rng, (3, 3, c, c), 0.05)
        scale, bias = _affine(rng, c)
        w = w32.bfloat16()
        oihw = w32.permute(3, 2, 0, 1).contiguous()
        prep_ms = cuda_ms(lambda: fc._hwio(oihw, torch.bfloat16))
        w_lib = w.permute(3, 2, 0, 1).contiguous()
        for b in SERVE_BATCHES + [SIAMESE_BATCH, TRAIN_BATCH]:
            x = _tensor(rng, (b, s, s, c)).bfloat16()
            names = ("conv3x3_small",) if s == 8 else (
                "conv3x3_small_bn_relu", "conv3x3_small")
            for name in names:
                extra = {"weight_prep_ms": prep_ms}
                if name == "conv3x3_small_bn_relu":
                    run = lambda: fc.conv3x3_small_bn_relu(  # noqa: E731
                        x, w, scale, bias)
                    z = fc._affine_relu(x, scale, bias)
                    plain = lambda: fc._plain_conv3x3(  # noqa: E731
                        fc._affine_relu(x, scale, bias), w)
                    library = None
                    # the eager two-call sequence the fusion replaces
                    extra["sequence"] = lambda: F.conv2d(  # noqa: E731
                        fc._affine_relu(x, scale, bias).permute(0, 3, 1, 2),
                        w_lib, padding=1)
                else:
                    run = lambda: fc.conv3x3_small(x, w)  # noqa: E731
                    z = x
                    plain = lambda: fc._plain_conv3x3(x, w)  # noqa: E731
                    xl = x.permute(0, 3, 1, 2)
                    library = lambda: F.conv2d(  # noqa: E731
                        xl, w_lib, padding=1)
                max_err, worst = _check(
                    f"{name} B={b} S={s} C={c}", run(),
                    fc._plain_conv3x3(z.float(), w.float()), ATOL, RTOL)
                _time_row(records, name, b, s, c, run, plain, library,
                          max_err, worst, **extra)


def _time_row(records, name, b, s, c, run, plain, library, max_err, worst,
              **extra):
    """Times a kernel against its plain version and the library call by
    CUDA events; each ``extra`` that is a function (a yardstick: the eager
    sequence a fusion replaces) is timed as ``<key>_ms``, and a number is
    kept as it is. At the training batch and the siamese one the kernel,
    the library call and the yardsticks are also timed by profiler device
    time
    (``kernel_device_ms``, ``library_device_ms``, ``<key>_device_ms``),
    which no Python launch overhead inflates."""
    plain_ms1 = cuda_ms(plain)
    ms = cuda_ms(run)
    plain_ms2 = cuda_ms(plain)
    library_ms = cuda_ms(library) if library is not None else None
    bound_ms, bound_by = bound(*conv_cost(name, b, s, c))
    yardsticks = {k: v for k, v in extra.items() if callable(v)}
    times = {k: v for k, v in extra.items() if not callable(v)}
    times.update({f"{k}_ms": cuda_ms(fn) for k, fn in yardsticks.items()})
    if b in (TRAIN_BATCH, SIAMESE_BATCH):
        times["kernel_device_ms"] = device_ms(run)
        if library is not None:
            times["library_device_ms"] = device_ms(library)
        times.update({f"{k}_device_ms": device_ms(fn)
                      for k, fn in yardsticks.items()})
    row = {"B": b, "S": s, "C": c, "max_abs_err": max_err,
           "err_over_bound": worst, "ms": ms,
           "plain_ms": (plain_ms1 + plain_ms2) / 2, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms, **times}
    _record(records, name, row)
    lib = f"{library_ms * 1e3:.1f} us" if library_ms is not None else "-"
    print(f"time {name:22s} B={b:4d} S={s} C={c}: kernel {ms * 1e3:.1f} us, "
          f"plain bf16 {plain_ms1 * 1e3:.1f}/{plain_ms2 * 1e3:.1f} us, "
          f"library {lib}, bound {bound_ms * 1e3:.2f} us ({bound_by})"
          + "".join(f", {k} {v * 1e3:.1f} us" for k, v in times.items()))


def _wgrad_library(g_nchw, x_nchw, w_oihw):
    """The weight gradient alone, in one library call."""
    return torch.ops.aten.convolution_backward(
        g_nchw, x_nchw, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
        1, [False, True, False])


def backward_kernel_phase(records):
    """K1 as the dgrad, K2 and K4 against their plain versions at the
    training shapes."""
    rng = np.random.default_rng(SEED + 1)
    for s, c, _ in MIXED_SHAPES + FUSED_SHAPES:
        w = _tensor(rng, (3, 3, c, c), 0.05).bfloat16()
        w_lib = w.permute(3, 2, 0, 1).contiguous()
        scale, bias = _affine(rng, c)
        for b in (TRAIN_BATCH, SMALL_BATCH, RAGGED_BATCH):
            x = _tensor(rng, (b, s, s, c)).bfloat16()
            g = _tensor(rng, (b, s, s, c)).bfloat16()
            x_lib, g_lib = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

            # K1 as the dgrad: the conv of g with the flipped weight
            max_err, worst = _check(
                f"conv3x3_dgrad B={b} S={s} C={c}", fc.conv3x3_dgrad(g, w),
                fc._plain_conv3x3(g.float(), fc._flip(w).float()), ATOL,
                RTOL)
            _time_row(records, "conv3x3_dgrad", b, s, c,
                      lambda: fc.conv3x3_dgrad(g, w),
                      lambda: fc._plain_conv3x3(g, fc._flip(w)),
                      lambda: F.conv_transpose2d(g_lib, w_lib, padding=1),
                      max_err, worst)

            # K2 (on the step at 8x8, the mixed op) at every training
            # shape; K4 at 4x4 and 2x2 (the fused op)
            names = ["conv3x3_wgrad"] + (["conv3x3_wgrad_bn_relu"] if s != 8
                                         else [])
            for name in names:
                if name == "conv3x3_wgrad":
                    z = x
                    run = lambda: fc.conv3x3_wgrad(x, g)  # noqa: E731
                    plain = lambda: fc._plain_wgrad(x, g)  # noqa: E731
                    library = lambda: _wgrad_library(  # noqa: E731
                        g_lib, x_lib, w_lib)
                    extra = {}
                else:
                    z = fc._affine_relu(x, scale, bias)
                    run = lambda: fc.conv3x3_wgrad_bn_relu(  # noqa: E731
                        x, g, scale, bias)
                    plain = lambda: fc._plain_wgrad_bn_relu(  # noqa: E731
                        x, g, scale, bias)
                    library = None
                    # the eager two-call sequence the fusion replaces
                    extra = {"sequence": lambda: _wgrad_library(  # noqa
                        g_lib, fc._affine_relu(x, scale, bias).permute(
                            0, 3, 1, 2), w_lib)}
                want = fc._plain_wgrad(z.float(), g.float())
                got = run()
                if not torch.equal(got, run()):
                    raise AssertionError(f"{name}: two launches differ")
                max_err, worst = _check(
                    f"{name} B={b} S={s} C={c}", got, want,
                    WGRAD_REL * want.abs().max().item(), 0.0)
                _time_row(records, name, b, s, c, run, plain, library,
                          max_err, worst, **extra)


def cold_ms(fn, flush, iters=50, warmup=3):
    """Device time of one call of ``fn`` with L2 cold: ``flush()`` (a pass
    over FLUSH_BYTES) before each launch, and the launch alone between two
    CUDA events; the mean over ``iters``. The device first sleeps for
    about 100 us an iteration, so the host has enqueued every launch before
    the device reaches its start event: were the device to catch up, the
    events would also time its wait for the host's next launch (a flush
    takes ~20 us of device time, about what the host takes to enqueue a
    flush, two events and a launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * SLEEP_CYCLES_PER_ITER)
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def host_us(fn, launches=HOST_LAUNCHES):
    """The host's enqueue cost of one call of ``fn``: ``launches`` calls
    with no synchronize on the host clock, after one call and a
    synchronize; microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / launches * 1e6


def normalize_kernel_phase(records):
    """T2 against its plain version, exact: all 256 u8 values, the training
    batch, a tail size and two misaligned views; then timed at the training
    batch beside ``torch.mul`` into bf16, hot, cold and on the host."""
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, 64, 64, 3),
                                      np.uint8)).cuda()
    flat = torch.from_numpy(rng.integers(0, 256, T2_TAIL + 8,
                                         np.uint8)).cuda()
    every = torch.arange(256, dtype=torch.uint8, device=DEVICE)
    cases = {"all 256 u8 values": every,
             f"B={TRAIN_BATCH} [64, 64, 3]": x,
             f"tail: {T2_TAIL} elements": flat[:T2_TAIL],
             f"offset 1: {T2_TAIL + 7} elements": flat[1:],
             f"offset 8: {T2_TAIL} elements": flat[8:]}
    for label, t in cases.items():
        plan = pre.plan_normalize_u8(
            t.numel(), t.data_ptr() % pre.VECTOR,
            _cuda.sm_count(t.device.index),
            pre._blocks_per_sm(t.device.index))
        exact = torch.equal(pre.normalize_u8(t), pre._plain_normalize_u8(t))
        if t is every:
            exact = exact and torch.equal(
                pre.normalize_u8(every), (every.float() / 255.0).bfloat16())
        print(f"check normalize_u8 {label} ({plan}): tolerance exact (0), "
              f"equal {exact}")
        if not exact:
            raise AssertionError(f"normalize_u8 differs from its plain "
                                 f"version: {label}")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=DEVICE)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    run = lambda: pre.normalize_u8(x)  # noqa: E731
    mul = lambda: torch.mul(x, 1.0 / 255.0, out=out)  # noqa: E731
    write = lambda: scratch.fill_(1)  # noqa: E731
    plain_ms1 = cuda_ms(lambda: pre._plain_normalize_u8(x))
    # each reading in turns, kernel, torch.mul, torch.mul, kernel
    readings = {}
    for key, reading in (
            ("ms", cuda_ms), ("device_ms", device_ms),
            ("cold_ms", lambda fn: cold_ms(fn, write)),
            ("cold_after_read_ms", lambda fn: cold_ms(fn, scratch.sum)),
            ("host_us", host_us)):
        a1, b1, b2, a2 = reading(run), reading(mul), reading(mul), reading(run)
        readings[key] = (a1 + a2) / 2
        readings[f"library_{key}"] = (b1 + b2) / 2
        readings[f"{key}_reads"] = [a1, a2, b1, b2]
    plain_ms2 = cuda_ms(lambda: pre._plain_normalize_u8(x))
    # the share of T2's host cost that is its output's allocation, which
    # torch.mul into a given tensor does not make
    readings["alloc_host_us"] = host_us(lambda: torch.empty(
        x.shape, dtype=torch.bfloat16, device=DEVICE))
    bound_ms, bound_by = bound(0, x.numel() * 3)
    _record(records, "normalize_u8", {
        "B": TRAIN_BATCH, "shape": [64, 64, 3], "max_abs_err": 0.0,
        "err_over_bound": 0.0, "plain_ms": (plain_ms1 + plain_ms2) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by,
        **{k: v for k, v in readings.items() if not k.endswith("_reads")}})
    r = readings
    print(f"time normalize_u8 B={TRAIN_BATCH}: bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}), plain bf16 {plain_ms1 * 1e3:.1f}/"
          f"{plain_ms2 * 1e3:.1f} us; kernel against torch.mul into bf16: "
          f"event back to back {r['ms'] * 1e3:.2f} / "
          f"{r['library_ms'] * 1e3:.2f} us, device (profiler) "
          f"{r['device_ms'] * 1e3:.2f} / {r['library_device_ms'] * 1e3:.2f} "
          f"us, cold (64 MB written before each) {r['cold_ms'] * 1e3:.2f} / "
          f"{r['library_cold_ms'] * 1e3:.2f} us, cold (64 MB read before "
          f"each) {r['cold_after_read_ms'] * 1e3:.2f} / "
          f"{r['library_cold_after_read_ms'] * 1e3:.2f} us, host enqueue "
          f"{r['host_us']:.2f} / {r['library_host_us']:.2f} us (the "
          f"output's torch.empty alone {r['alloc_host_us']:.2f} us); each "
          f"read (kernel, kernel, torch.mul, torch.mul): "
          + "; ".join(f"{k[:-6]} " + ", ".join(f"{v:.5f}" for v in reads)
                      for k, reads in r.items() if k.endswith("_reads")))


# The BatchNorm layers the timing phase walks: the flagship (ResNet-50 at 64
# px, fused BN-ReLU conv on) and the B3 cell's EfficientNet-B3 at 96 px.
BN_MODELS = (("resnet50", 64, True), ("efficientnet-b3", 96, False))


def _bn_layer_shapes(name, size, fast_conv):
    """``{(kind, C, H, W): layers}`` of ``name``'s BatchNorms at ``size``
    px, from a train-mode forward of one image on the CPU: ``kind``
    BatchNorm (the affine applied) or BNScaleBias (the fused conv's)."""
    import collections
    module = EmbeddingModule(name, encodings_len=256, fast_conv=fast_conv,
                             input_shape=(size, size, 3))
    shapes = collections.Counter()

    def hook(mod, args):
        kind = ("BNScaleBias" if type(mod) is fc.BNScaleBias
                else "BatchNorm")
        shapes[(kind,) + tuple(args[0].shape[1:])] += 1
    for mod in module.modules():
        if isinstance(mod, fc.BNScaleBias):
            mod.register_forward_pre_hook(hook)
    with torch.no_grad():
        module.train()(torch.rand(1, size, size, 3))
    return shapes


# BatchNorm's checks, each error a share of the plain version's largest
# entry (tests/test_torch_port_cuda.py BN_F32, BN_BF16): f32 outputs,
# running averages and parameter gradients to BN_SMOKE_F32 (sums of up to
# a million terms added in another order, rsqrtf's 2 ulp); bf16 outputs and
# dx to BN_SMOKE_BF16 (one bf16 rounding of values the two sides compute a
# few f32 ulp apart). BatchNorm's cotangent is noise plus BN_DY_SLOPE * the
# normalised input plus BN_DY_SHIFT, so that the backward's batch-mean and
# projection terms are as large as dx itself: a kernel that drops or
# misweighs one is off by more than the tolerance
BN_SMOKE_F32, BN_SMOKE_BF16 = 1e-4, 1e-2
BN_DY_SLOPE, BN_DY_SHIFT = 1.0, 1.0


def _bn_rel(label, got, want, tol):
    """The largest error of ``got`` as a share of ``want``'s largest
    entry; raises past ``tol``."""
    got, want = got.detach().double(), want.detach().double()
    ref = max(want.abs().max().item(), 1e-30)
    rel = (got - want).abs().max().item() / ref
    if not torch.isfinite(got).all() or not rel <= tol:
        raise AssertionError(f"{label}: error {rel:.3e} of the largest "
                             f"entry, tolerance {tol:g}")
    return rel


def _bn_check_layer(kind, bn, x, rng):
    """One layer's kernels against the plain version on the card from one
    state and the same input values (f32 on the plain side): the forward
    (y, or BNScaleBias's (scale, bias)), the running averages and batch
    count, dx, dgamma and dbeta; and its launches, each once ({bn_stats,
    bn_apply, bn_bwd_reduce, bn_bwd_dx} a BatchNorm, {bn_stats,
    bn_finalize, bn_bwd_dx} a BNScaleBias). Returns {kernel: worst error
    share} and the cotangent."""
    import copy
    c = x.shape[1]
    plain = copy.deepcopy(bn)
    if kind == "BatchNorm":
        xf = x.float()
        xhat = (xf - xf.mean((0, 2, 3), keepdim=True)) * torch.rsqrt(
            xf.var((0, 2, 3), unbiased=False, keepdim=True) + bn.eps)
        cot = (torch.randn_like(xf) + BN_DY_SLOPE * xhat
               + BN_DY_SHIFT).to(torch.bfloat16)
        del xf, xhat
    else:
        cot = tuple(torch.from_numpy(rng.normal(size=c).astype(
            np.float32)).cuda() for _ in range(2))
    outs = {}
    for side, mod in (("kernels", bn), ("plain", plain)):
        # the plain version from the same values in f32: its bf16 route
        # casts x twice and adds dx's two parts in bf16, each rounded
        # apart, a reference less exact than the kernels' one rounding
        xr = x.detach().to(torch.float32 if side == "plain" else x.dtype,
                           memory_format=torch.channels_last)
        xr.requires_grad_()
        bnk.reset_launch_counts()
        if kind == "BatchNorm":
            fn = bnk.batch_norm if side == "kernels" else bnk.plain_batch_norm
            out = (fn(mod, xr, torch.bfloat16),)
            out[0].backward(cot)
        else:
            fn = bnk.scale_bias if side == "kernels" else bnk.plain_scale_bias
            out = fn(mod, xr)
            (out[0] * cot[0] + out[1] * cot[1]).sum().backward()
        torch.cuda.synchronize()
        outs[side] = ([o.detach() for o in out], xr.grad, mod.weight.grad,
                      mod.bias.grad, mod.running_mean.clone(),
                      mod.running_var.clone(),
                      mod.num_batches_tracked.item(), dict(bnk.LAUNCHES))
        del xr
    (fwd, dx, dg, db, rm, rv, n, launches), want = (outs["kernels"],
                                                    outs["plain"])
    label = f"batchnorm {kind} C={c} {x.shape[2]}x{x.shape[3]}"
    expected = ({"bn_stats": 1, "bn_apply": 1, "bn_bwd_reduce": 1,
                 "bn_bwd_dx": 1} if kind == "BatchNorm" else
                {"bn_stats": 1, "bn_finalize": 1, "bn_bwd_dx": 1})
    if launches != {k: expected.get(k, 0) for k in launches}:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expected}")
    if n != want[6]:
        raise AssertionError(f"{label}: num_batches_tracked {n}, plain "
                             f"{want[6]}")
    grads = "bn_bwd_reduce" if kind == "BatchNorm" else "bn_finalize"
    err = {
        "bn_stats": max(_bn_rel(f"{label} {what}", g, w, BN_SMOKE_F32)
                        for what, g, w in (("running_mean", rm, want[4]),
                                           ("running_var", rv, want[5]))),
        "bn_bwd_dx": _bn_rel(f"{label} dx", dx, want[1], BN_SMOKE_BF16),
        grads: max(_bn_rel(f"{label} {what}", g, w, BN_SMOKE_F32)
                   for what, g, w in (("dgamma", dg, want[2]),
                                      ("dbeta", db, want[3]))),
    }
    if kind == "BatchNorm":
        err["bn_apply"] = _bn_rel(f"{label} y", fwd[0], want[0][0],
                                  BN_SMOKE_BF16)
    else:
        err["bn_stats"] = max(err["bn_stats"], *(
            _bn_rel(f"{label} {what}", g, w, BN_SMOKE_F32)
            for what, g, w in zip(("scale", "bias"), fwd, want[0])))
    print(f"check {label}: forward, running averages, dx, dgamma, dbeta "
          f"against the plain version, worst error shares " + ", ".join(
              f"{k} {v:.2e}" for k, v in sorted(err.items())))
    return err, cot


def batchnorm_kernel_phase(records):
    """The BatchNorm kernels (``csrc/batchnorm_sm90.cu``) at every BatchNorm
    shape of the two cells' models at B=1,024, bf16 activations: each
    layer's forward and backward checked against the plain version
    (``_bn_check_layer``), then each kernel timed with CUDA events beside
    its bytes bound (x read, y, dx written, each once: the statistics
    R*C*2 bytes, the affine 4, the backward's sums 4, dx 6), the plain
    eager forward and backward, and ``F.batch_norm``'s (a yardstick the
    port never calls), all summed over the step's layers."""
    rng = np.random.default_rng(SEED + 5)
    out = {"max_rel_err": {name: 0.0 for name in bnk.LAUNCHES}}
    for name, size, fast in BN_MODELS:
        shapes = _bn_layer_shapes(name, size, fast)
        step = {"kernels_ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "layers": sum(shapes.values())}
        rows = []
        for (kind, c, h, w), layers in sorted(shapes.items()):
            x = torch.from_numpy((rng.normal(size=(TRAIN_BATCH, h, w, c))
                                  * 2 + 1).astype(np.float32)).cuda().to(
                torch.bfloat16).permute(0, 3, 1, 2)
            bn = (fc.BNScaleBias(c, momentum=0.9) if kind == "BNScaleBias"
                  else _bn_module(c)).cuda().train()
            err, cot = _bn_check_layer(kind, bn, x, rng)
            for k, v in err.items():
                out["max_rel_err"][k] = max(out["max_rel_err"][k], v)
            dy = cot if kind == "BatchNorm" else torch.randn_like(x)
            call = bnk._call(bn, x, None)
            stat = torch.empty((4, c), device=DEVICE)
            coef = torch.empty((4, c), device=DEVICE)
            y = torch.empty_like(x)
            dg, db = torch.empty_like(bn.weight), torch.empty_like(bn.bias)
            n = x.numel() * 2
            fns = {"bn_stats": (lambda: bnk._stats(
                call, x, stat, bnk.TRAIN), n)}
            if kind == "BatchNorm":
                fns["bn_apply"] = (lambda: bnk._apply(call, x, y, stat),
                                   2 * n)
                fns["bn_bwd_reduce"] = (lambda: bnk._bwd_reduce(
                    call, x, dy, coef,
                    bnk.BACKWARD | bnk.TRAIN | bnk.DIRECT, stat, dg, db),
                    2 * n)
                fns["bn_bwd_dx"] = (lambda: bnk._bwd_dx(call, x, dy, coef),
                                    3 * n)
            else:
                fns["bn_finalize"] = (lambda: bnk._finalize(
                    call, coef, bnk.BACKWARD | bnk.TRAIN,
                    local=(stat[3], stat[2]), stat=stat, dgamma=dg,
                    dbeta=db), 0)
                fns["bn_bwd_dx"] = (lambda: bnk._bwd_dx(call, x, None, coef),
                                    2 * n)
            bnk._stats(call, x, stat, bnk.TRAIN)
            row = {"kind": kind, "C": c, "H": h, "W": w, "layers": layers,
                   "max_rel_err": err}
            for key, (fn, nbytes) in fns.items():
                row[key + "_ms"] = cuda_ms(fn, iters=20)
                row[key + "_bound_ms"] = bound(0, nbytes)[0]
            xr = x.detach().requires_grad_()

            def plain():
                if kind == "BatchNorm":
                    o = bnk.plain_batch_norm(bn, xr, torch.bfloat16)
                    o.backward(dy)
                else:
                    s, b = bnk.plain_scale_bias(bn, xr)
                    (s.sum() + b.sum()).backward()

            def library():
                o = F.batch_norm(xr, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, True, 0.1, bn.eps)
                o.backward(dy)
            row["plain_ms"] = cuda_ms(plain, iters=10)
            row["library_ms"] = cuda_ms(library, iters=10)
            row["kernels_ms"] = sum(row[k + "_ms"] for k in fns)
            row["bound_ms"] = sum(row[k + "_bound_ms"] for k in fns)
            for key in ("kernels_ms", "bound_ms", "plain_ms", "library_ms"):
                step[key] += layers * row[key]
            rows.append(row)
            del x, dy, y, xr, cot
        print(f"time batchnorm {name} {size} px, B={TRAIN_BATCH}, "
              f"{step['layers']} layers a step: kernels forward and backward "
              f"{step['kernels_ms']:.3f} ms (bound {step['bound_ms']:.3f}), "
              f"plain eager {step['plain_ms']:.3f}, F.batch_norm "
              f"{step['library_ms']:.3f}")
        out[name] = {"step": step, "shapes": rows}
    records["batchnorm"] = out
    print(json.dumps({"batchnorm": out}))
    return out


# The attention kernels' checks: (B, N, heads, head dim, dtype); the first
# is the ViT-B/16 cell's core (224 px), the others ViT-B/32's 50 tokens,
# ViT-L/14's 257, one token, a ragged batch, a tensor-parallel half, d = 32,
# d = 128, fp16
ATT_CELL = (256, 197, 12, 64)
ATT_SHAPES = [ATT_CELL + (torch.bfloat16,), (8, 50, 12, 64, torch.bfloat16),
              (4, 257, 16, 64, torch.bfloat16), (3, 1, 12, 64, torch.bfloat16),
              (3, 197, 12, 64, torch.bfloat16),
              (4, 197, 6, 64, torch.bfloat16),
              (4, 197, 4, 32, torch.bfloat16),
              (2, 130, 2, 128, torch.bfloat16),
              (4, 197, 12, 64, torch.float16),
              (4, 197, 12, 64, torch.float32), (2, 50, 4, 40, torch.float32),
              (4, 197, 12, 64, torch.float64), (3, 1, 12, 64, torch.float64)]
# each result against the float32 plain path, relative to its largest
# entry: the kernels round q, k, v, P and dS to 16 bits, and the result
ATT_REL = 2e-2
# _forward's logsumexp and _backward's dq, dk, dv against
# plain_forward_lse and plain_backward in float64 from the same inputs
# (the output and gradients relative to their largest entry, the
# logsumexp absolute), by input dtype: 16 bits as above, the logsumexp f32
# sums of exact products in another order; float32 sums in another order
# (1e-5, the ViT card check's); float64's (1e-10)
ATT_REFERENCE = {torch.bfloat16: (ATT_REL, 1e-4),
                 torch.float16: (ATT_REL, 1e-4),
                 torch.float32: (1e-5, 1e-4), torch.float64: (1e-10, 1e-10)}


def _att_inputs(rng, b, n, h, d, dtype):
    """q, k, v [b, n, h*d] with unit-variance scores, and an output
    gradient, on the card in ``dtype``."""
    t = [torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(
        np.float32)).cuda() for _ in range(4)]
    t[0] = t[0] * 1.5            # some rows of the softmax peak
    return [x.to(dtype) for x in t]


def _att_rel(got, want):
    """The largest error over the largest entry of ``want`` (over 1 where
    ``want`` is 0: one token's dq and dk)."""
    scale = want.abs().max().item() or 1.0
    return (got.float() - want).abs().max().item() / scale


def _att_reference(q, k, v, do, h, d):
    """The errors of ``_forward``'s output and logsumexp and ``_backward``'s
    dq, dk, dv against ``plain_forward_lse`` and ``plain_backward`` in
    float64 from the same inputs (the logsumexp's absolute, the others'
    over their largest entry; one token's dq and dk, zero in exact
    arithmetic, absolute)."""
    out, lse = att._forward(q, k, v, h, d, keep_lse=True)
    grads = att._backward(q, k, v, out, do, lse, h, d)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    want, want_lse = att.plain_forward_lse(q64, k64, v64, h)
    wants = att.plain_backward(q64, k64, v64, want, do64, want_lse, h)
    errs = {"lse": (lse.double() - want_lse).abs().max().item()}
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *grads),
                            (want, *wants)):
        exact_zero = q.shape[1] == 1 and name in ("dq", "dk")
        errs[name] = ((got.double() - w).abs().max().item()
                      / (1.0 if exact_zero else w.abs().max().item()))
    return errs


def attention_kernel_phase(records):
    """The attention kernels (``csrc/attention_sm90.cu``) against the
    float32 plain path at the shapes of ATT_SHAPES, forward and dq, dk, dv
    (the bf16 plain path's errors beside them), twice bit for bit, and
    their logsumexp and gradients against the reference algebra in float64
    (ATT_REFERENCE); then at
    the cell's shape timed with CUDA events and profiler device time beside
    their bytes bounds (forward: q, k, v read and the output written once,
    ``benchmark/vit_flops.py``'s count; backward: q, k, v, O, dO and the
    logsumexp read, dq, dk, dv written), the plain bf16 path and
    ``F.scaled_dot_product_attention`` (a yardstick the port never
    calls)."""
    rng = np.random.default_rng(SEED + 7)
    failures, rows = [], []
    for b, n, h, d, dtype in ATT_SHAPES:
        q, k, v, do = _att_inputs(rng, b, n, h, d, dtype)
        qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
        want = att.plain_attention(qf, kf, vf, h)
        want_grads = torch.autograd.grad(want, (qf, kf, vf), do.float())
        qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
        plain = att.plain_attention(qb, kb, vb, h)
        plain_grads = torch.autograd.grad(plain, (qb, kb, vb), do)
        before = dict(att.LAUNCHES)
        got, grads = [], []
        for _ in range(2):
            qk, kk, vk = (x.clone().requires_grad_() for x in (q, k, v))
            out = att.attention(qk, kk, vk, h)
            got.append(out)
            grads.append(torch.autograd.grad(out, (qk, kk, vk), do))
        torch.cuda.synchronize()
        launched = {key: att.LAUNCHES[key] - before[key] for key in before}
        errs = {"out": _att_rel(got[0], want)}
        plain_errs = {"out": _att_rel(plain, want)}
        for name, g, pg, w in zip(("dq", "dk", "dv"), grads[0], plain_grads,
                                  want_grads):
            errs[name] = _att_rel(g, w)
            plain_errs[name] = _att_rel(pg, w)
        repeat = (torch.equal(got[0], got[1])
                  and all(torch.equal(x, y) for x, y in zip(*grads)))
        finite = all(torch.isfinite(x).all() for x in [got[0], *grads[0]])
        reference = _att_reference(q, k, v, do, h, d)
        tol, lse_tol = ATT_REFERENCE[dtype]
        label = f"B={b} N={n} h={h} d={d} {str(dtype)[6:]}"
        ok = (finite and repeat and max(errs.values()) <= ATT_REL
              and reference["lse"] <= lse_tol
              and max(err for key, err in reference.items()
                      if key != "lse") <= tol
              and launched == {"fwd": 2, "bwd": 2, "plain": 0})
        print(f"check attention {label}: max error over the f32 plain path's "
              f"largest entry " + ", ".join(
                  f"{k} {v:.2e} (plain {plain_errs[k]:.2e})"
                  for k, v in errs.items())
              + f"; tolerance {ATT_REL:g}; against the float64 reference "
              + ", ".join(f"{key} {err:.2e}"
                          for key, err in reference.items())
              + f" (tolerance {tol:g}, logsumexp {lse_tol:g} absolute); "
              f"bit-equal rerun {repeat}; launches {launched}")
        rows.append({"shape": [b, n, h, d], "dtype": str(dtype),
                     "max_rel_err": errs, "plain_max_rel_err": plain_errs,
                     "reference_err": reference, "repeat_equal": repeat})
        if not ok:
            failures.append(label)
        del q, k, v, do, qf, kf, vf, want, want_grads, plain, plain_grads
        del got, grads
    if failures:
        raise AssertionError(f"attention kernels failed at {failures}")

    b, n, h, d = ATT_CELL
    q, k, v, do = _att_inputs(rng, b, n, h, d, torch.bfloat16)
    head = lambda t: t.view(b, n, h, d).transpose(1, 2)  # noqa: E731
    qh, kh, vh = head(q), head(k), head(v)
    out, lse = att._forward(q, k, v, h, d, keep_lse=True)
    fwd = lambda: att._forward(q, k, v, h, d, keep_lse=True)  # noqa: E731
    bwd = lambda: att._backward(  # noqa: E731
        q, k, v, out, do, lse, h, d)
    plain_fwd = lambda: att.plain_attention(q, k, v, h)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    qgh, kgh, vgh = (x.clone().requires_grad_() for x in (qh, kh, vh))

    def plain_both():
        y = att.plain_attention(qg, kg, vg, h)
        torch.autograd.grad(y, (qg, kg, vg), do)

    def sdpa_both():
        y = F.scaled_dot_product_attention(qgh, kgh, vgh)
        torch.autograd.grad(y, (qgh, kgh, vgh), head(do))
    # operations 4 b h n^2 d forward (benchmark/vit_flops.py attention_cost)
    # and 2.5 times that backward; q, k, v, O, dO and dq, dk, dv in bf16
    flops, cell = 4 * b * h * n * n * d, b * n * h * d * 2
    fwd_bound = bound(flops, 4 * cell)
    bwd_bound = bound(5 * flops // 2, 8 * cell + b * h * n * 4)
    times = {"fwd_ms": cuda_ms(fwd), "bwd_ms": cuda_ms(bwd),
             "plain_fwd_ms": cuda_ms(plain_fwd, iters=20),
             "plain_fwd_bwd_ms": cuda_ms(plain_both, iters=10),
             "library_fwd_ms": cuda_ms(sdpa),
             "library_fwd_bwd_ms": cuda_ms(sdpa_both, iters=20),
             "fwd_device_ms": device_ms(fwd), "bwd_device_ms": device_ms(bwd),
             "library_fwd_device_ms": device_ms(sdpa)}
    times["fwd_ms_again"] = cuda_ms(fwd)
    times["bwd_ms_again"] = cuda_ms(bwd)
    row = {"shape": [b, n, h, d], "fwd_bound_ms": fwd_bound[0],
           "fwd_bound_by": fwd_bound[1], "bwd_bound_ms": bwd_bound[0],
           "bwd_bound_by": bwd_bound[1], **times}
    print(f"time attention B={b} N={n} h={h} d={d} bf16: forward "
          f"{times['fwd_ms'] * 1e3:.1f}/{times['fwd_ms_again'] * 1e3:.1f} us "
          f"(device {times['fwd_device_ms'] * 1e3:.1f}; bound "
          f"{fwd_bound[0] * 1e3:.1f}, {fwd_bound[1]}), backward "
          f"{times['bwd_ms'] * 1e3:.1f}/{times['bwd_ms_again'] * 1e3:.1f} us "
          f"(device {times['bwd_device_ms'] * 1e3:.1f}; bound "
          f"{bwd_bound[0] * 1e3:.1f}, {bwd_bound[1]}); plain bf16 forward "
          f"{times['plain_fwd_ms'] * 1e3:.1f} us, forward and backward "
          f"{times['plain_fwd_bwd_ms'] * 1e3:.1f}; "
          f"F.scaled_dot_product_attention forward "
          f"{times['library_fwd_ms'] * 1e3:.1f} us (device "
          f"{times['library_fwd_device_ms'] * 1e3:.1f}), forward and "
          f"backward {times['library_fwd_bwd_ms'] * 1e3:.1f}")
    records["attention"] = {"checks": rows, "cell": row}
    print(json.dumps({"attention": records["attention"]}))
    return records["attention"]


def _bn_per_step(module):
    """BatchNorm's launches in one training step of ``module``: a
    BatchNorm layer launches bn_stats, bn_apply, bn_bwd_reduce and
    bn_bwd_dx once, a BNScaleBias (the fused conv's) bn_stats, bn_finalize
    and bn_bwd_dx."""
    fused = sum(type(m) is fc.BNScaleBias for m in module.modules())
    applied = sum(isinstance(m, fc.BNScaleBias)
                  for m in module.modules()) - fused
    return {"bn_stats": applied + fused, "bn_apply": applied,
            "bn_bwd_reduce": applied, "bn_bwd_dx": applied + fused,
            "bn_finalize": fused}


def _bn_kernel_line(name, route, source, replaces, rec, launches):
    """A BatchNorm kernel's entry of the kernels line: its launches in the
    augmented training step, its worst error share in the phase's checks,
    and its CUDA-event time and bytes bound summed over ResNet-50's
    layers."""
    layers = [r for r in rec["resnet50"]["shapes"] if name + "_ms" in r]
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_rel_err": rec["max_rel_err"][name],
            "ms": sum(r["layers"] * r[name + "_ms"] for r in layers),
            "bound_ms": sum(r["layers"] * r[name + "_bound_ms"]
                            for r in layers),
            "per": f"augmented training step (ResNet-50), B={TRAIN_BATCH}; "
                   f"ms the phase's back-to-back events summed over the "
                   f"layers"}


def _att_kernel_line(name, route, source, replaces, rec):
    """An attention kernel's entry of the kernels line: its launches on each
    ViT path the smoke drove (ATT_LAUNCHES; a plain count beside them), its
    worst error share against the float32 plain path in the phase's
    checks, and its CUDA-event and profiler device time, the plain bf16
    path's, F.scaled_dot_product_attention's (a yardstick the port never
    calls; a backward as forward-and-backward less forward) and the bytes
    bound at the cell's core, summed over the cell's ATT_STEP_CALLS."""
    role = name.rsplit("_", 1)[1]
    cell, calls = rec["cell"], ATT_STEP_CALLS[role]
    if role == "fwd":
        errs, plain, library = (("out",), cell["plain_fwd_ms"],
                                cell["library_fwd_ms"])
    else:
        errs = ("dq", "dk", "dv")
        plain = cell["plain_fwd_bwd_ms"] - cell["plain_fwd_ms"]
        library = cell["library_fwd_bwd_ms"] - cell["library_fwd_ms"]
    b, n, h, d = cell["shape"]
    return {"name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": {path: c[role] for path, c in ATT_LAUNCHES.items()},
            "plain_launches": {path: c["plain"]
                               for path, c in ATT_LAUNCHES.items()},
            "max_rel_err": max(row["max_rel_err"][k]
                               for row in rec["checks"] for k in errs),
            "ms": cell[f"{role}_ms"] * calls,
            "device_ms": cell[f"{role}_device_ms"] * calls,
            "plain_ms": plain * calls, "library_ms": library * calls,
            "bound_ms": cell[f"{role}_bound_ms"] * calls,
            "bound_by": cell[f"{role}_bound_by"],
            "per": f"one step of the benchmark cell vit-b16-arcface-train, "
                   f"{calls} calls at B={b} N={n} h={h} d={d} bf16; "
                   f"launches by ViT path"}


def attention_paths():
    """``--vit``: the attention phase, phase 12 and phase 16's ViT runs
    (tensor parallel, pipeline), then the attention kernels' lines."""
    import shutil
    smi = check_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    records = {}
    attention_kernel_phase(records)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vit_")
    try:
        vit_phase(smi, tmp)
        tp_vit_phase(smi, tmp)
        pipeline_phase(smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": [
        _att_kernel_line(name, *KERNELS[name], records["attention"])
        for name in KERNELS if name.startswith("attention_")]}))
    print(smi)


def _bn_module(c):
    from embeddingnet_tpu_torch.models.resnet import BatchNorm
    return BatchNorm(c, eps=1e-3, momentum=0.9, compute_dtype=torch.bfloat16)


def _exact_epilogue_inputs(rng, b, s, c):
    """T1's inputs on which every rounding is known (as in the card test
    ``test_epilogue_kernel_is_bit_exact``): x and w small integers in bf16,
    so the conv's f32 sums are exact in any order; scales with full f32
    mantissas; for each output channel n the bias -fl(y_n*scale_n), y_n the
    channel's most frequent conv value, where mul-then-add gives exactly 0
    and an FMA the product's rounding error. (x, w, scale, bias, exact y)."""
    x = torch.from_numpy(rng.integers(-2, 3, (b, s, s, c)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.integers(-1, 2, (3, 3, c, c)).astype(
        np.float32)).cuda()
    y = fc._plain_conv3x3(x.double(), w.double())
    if not torch.equal(fc._plain_conv3x3(x, w).double(), y):
        raise AssertionError("the integer conv is not exact in f32")
    y = y.float()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)
                             ).cuda()
    bias = -(y.reshape(-1, c).mode(0).values * scale)
    return x.bfloat16(), w.bfloat16(), scale, bias, y


def epilogue_exact_check(rng, b, s, c):
    """T1 equal to its plain version bit for bit on the exact inputs, where
    an FMA's results differ on some entries."""
    x, w, scale, bias, y = _exact_epilogue_inputs(rng, b, s, c)
    got = fc.conv3x3_small_affine_relu(x, w, scale, bias)
    want = fc._plain_conv3x3_affine_relu(x, w, scale, bias)
    fma = (y.double() * scale.double() + bias.double()).float().clamp_min(
        0.0).bfloat16()
    n_fma = int((fma != want).sum())
    equal = torch.equal(got, want)
    print(f"check conv3x3_small_affine_relu B={b} S={s} C={c} on exact "
          f"integer inputs: tolerance exact (0), equal {equal}; an FMA "
          f"would differ on {n_fma} of {want.numel()} entries")
    if not equal or n_fma == 0:
        raise AssertionError("T1 differs from its plain version on the "
                             "exact inputs (or they do not test an FMA)")


def epilogue_kernel_phase(records):
    """T1 against its plain version, in f32 (TF32 off) and in bf16, at the
    A/B tool's batch and a ragged and a mid batch, at stage 4's and stage
    3's shapes, and bit for bit on exact inputs at the tool's batch. Timed
    against the plain version, ``F.conv2d`` alone and the tool's eager conv
    -> affine -> ReLU sequence."""
    tool = runpy.run_path(TOOL)
    rng = np.random.default_rng(SEED + 2)
    name = "conv3x3_small_affine_relu"
    for s, c in EPILOGUE_SHAPES:
        w = _tensor(rng, (3, 3, c, c), 0.02).bfloat16()
        scale, bias = _affine(rng, c)
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        for b in EPILOGUE_BATCHES:
            x = _tensor(rng, (b, s, s, c)).bfloat16()
            run = lambda: fc.conv3x3_small_affine_relu(  # noqa: E731
                x, w, scale, bias)
            plain = lambda: fc._plain_conv3x3_affine_relu(  # noqa: E731
                x, w, scale, bias)
            got = run()
            errs = [_check(f"{name} B={b} S={s} C={c} vs {label}", got,
                           want.float(), ATOL, RTOL)
                    for label, want in (
                        ("f32 plain", fc._plain_conv3x3_affine_relu(
                            x.float(), w.float(), scale, bias)),
                        ("bf16 plain", plain()))]
            xl = x.permute(0, 3, 1, 2)
            _time_row(records, name, b, s, c, run, plain, None,
                      max(e[0] for e in errs), max(e[1] for e in errs),
                      conv2d=lambda: F.conv2d(xl, w_lib, padding=1),
                      eager_sequence=tool["library_path"](x, w, scale,
                                                          bias))
        epilogue_exact_check(rng, TOOL_BATCH, s, c)


def _profiled(events, name):
    """The device kernels among profiler ``events`` that are instances of
    the port's kernel ``name`` (PROFILED_NAMES)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and all(p in e.name for p in PROFILED_NAMES[name])]


def epilogue_tool_phase():
    """T1's path: the A/B tool's ``main`` on the card at B = 1024, under
    torch.profiler; returns (T1's launches in it, its device ms per launch
    there). The profiler must see exactly that many instances of T1's
    kernel (csrc/conv3x3_sm90.cu with the epilogue) and none of K3's."""
    from torch.profiler import ProfilerActivity, profile
    tool = runpy.run_path(TOOL)
    os.environ["FC_BATCH"] = str(TOOL_BATCH)
    name = "conv3x3_small_affine_relu"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # ---- the main path: every launch count from here to the reading --
        fc.reset_launch_counts()
        result = tool["main"](["--device", DEVICE])
        launches = dict(fc.LAUNCHES)
        # ---- end of the main path ----
        torch.cuda.synchronize()
    others = {k: v for k, v in launches.items() if k != name and v}
    if not launches[name] or others:
        raise AssertionError(f"the A/B tool launched {launches}")
    if result["batch"] != TOOL_BATCH:
        raise AssertionError(f"the tool ran at B={result['batch']}")
    events = prof.events()
    t1, k3 = _profiled(events, name), _profiled(events,
                                                "conv3x3_small_bn_relu")
    if len(t1) != launches[name] or k3:
        raise AssertionError(f"the profiler saw {len(t1)} T1 and {len(k3)} "
                             f"K3 kernels for {launches[name]} T1 launches")
    per_launch = sum(e.device_time_total for e in t1) * 1e-3 / len(t1)
    print(f"epilogue A/B (under torch.profiler): T1 launched "
          f"{launches[name]} times, {len(t1)} kernels of {t1[0].name[:70]}, "
          f"{per_launch * 1e3:.2f} us of device time each; best of 3: "
          f"library sequence {result['library_s'] * 1e3:.4f} ms, T1 "
          f"{result['t1_s'] * 1e3:.4f} ms")
    return launches[name], per_launch


def _to(draws, device):
    return [{k: v.to(device) for k, v in d.items()} for d in draws]


def augmentation_check_phase(db_images):
    """Every op of the four presets on the card against the same op on
    the CPU, from the same draws and the same input (the CPU chain's), to
    AUG_ATOL; then the ``default`` preset chained on both, counting the
    pixels past AUG_ATOL (CLAHE bin flips), at most AUG_FLIP_SHARE."""
    x_cpu = torch.from_numpy(db_images[:AUG_CHECK_BATCH]).float()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    seen = set()
    for preset in ("default", "plates", "deepfake", "plates2"):
        augment = aug.get_aug(preset)
        draws = augment.sample(x_cpu.shape, gen)
        h = x_cpu
        for op, d in zip(augment.ops, draws):
            want = op.apply(h, _to([d], "cpu")[0])
            got = op.apply(h.to(DEVICE), d).cpu()
            err = (got - want).abs().max().item()
            key = (op.name, tuple(sorted(op.params.items())))
            if key not in seen:
                seen.add(key)
                print(f"check augment {op.name} {op.params}: card vs CPU "
                      f"max abs err {err:.3e} (tolerance {AUG_ATOL})")
            if not torch.isfinite(got).all() or err > AUG_ATOL:
                raise AssertionError(f"augment {op.name} on the card "
                                     f"differs from the CPU by {err}")
            h = want
    augment = aug.get_aug(AUG_PRESET)
    draws = augment.sample(x_cpu.shape, gen)
    want = augment.apply(x_cpu, _to(draws, "cpu"))
    got = augment.apply(x_cpu.to(DEVICE), draws).cpu()
    off = ((got - want).abs().amax(-1) > AUG_ATOL)
    share = off.float().mean().item()
    print(f"check augment preset {AUG_PRESET} chained, B={AUG_CHECK_BATCH}: "
          f"{int(off.sum())} of {off.numel()} pixels past {AUG_ATOL} (CLAHE "
          f"bin flips; at most {AUG_FLIP_SHARE:g}), max abs err elsewhere "
          f"{(got - want).abs().amax(-1)[~off].max().item():.3e}")
    if share > AUG_FLIP_SHARE:
        raise AssertionError(f"augment preset differs on {share:.4%} of "
                             f"the pixels")


def _sum(rec, b, per):
    """ms / plain_ms / bound_ms / library_ms summed over ``per`` = [(S, C,
    calls)] at batch ``b``."""
    rows = {(r["S"], r["C"]): r for r in rec["shapes"] if r["B"] == b}
    out = {}
    keys = ["ms", "plain_ms", "bound_ms", "library_ms"]
    keys += [k for k in ("sequence_ms", "kernel_device_ms",
                         "library_device_ms", "sequence_device_ms")
             if all(k in rows[(s, c)] for s, c, _ in per)]
    for key in keys:
        vals = [rows[(s, c)][key] for s, c, _ in per]
        out[key] = (None if any(v is None for v in vals)
                    else sum(v * n for v, (_, _, n) in zip(vals, per)))
    bounds = [rows[(s, c)]["bound_by"] for s, c, _ in per]
    out["bound_by"] = max(set(bounds), key=bounds.count)
    return out


def synthetic(rng, base, classes):
    """uint8 images of ``classes``: each class's base image plus noise."""
    noise = rng.integers(-NOISE, NOISE + 1, (len(classes),) + base.shape[1:],
                         dtype=np.int16)
    return np.clip(base[classes].astype(np.int16) + noise, 0,
                   255).astype(np.uint8)


def direct(net, images):
    """Embeddings the way the collector makes them: batches padded to
    MAX_BATCH."""
    out = []
    for i in range(0, len(images), MAX_BATCH):
        chunk = images[i:i + MAX_BATCH]
        pad = np.zeros((MAX_BATCH,) + chunk.shape[1:], np.uint8)
        pad[:len(chunk)] = chunk
        out.append(net.encode(pad)[:len(chunk)])
    return np.concatenate(out)


def serving_phase():
    rng = np.random.default_rng(SEED)
    h, w, _ = FLAGSHIP["model"]["input_shape"]
    base = rng.integers(0, 256, (N_CLASSES, h, w, 3), dtype=np.uint8)
    db_classes = np.repeat(np.arange(N_CLASSES), PER_CLASS)
    db_images = synthetic(rng, base, db_classes)
    sizes = [1, 32, 100]
    query_classes = [rng.integers(0, N_CLASSES, n) for n in sizes]
    queries = [synthetic(rng, base, c) for c in query_classes]

    t0 = time.perf_counter()
    net = EmbeddingNet(FLAGSHIP, device=DEVICE, fast_conv=True,
                       dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"serve: model built in {time.perf_counter() - t0:.1f} s")

    # ---- the main path: every launch count from here to the reading ----
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    encodings = np.concatenate([
        net.encode(db_images[i:i + DB_BATCH])
        for i in range(0, len(db_images), DB_BATCH)])
    encode_s = time.perf_counter() - t0
    db_batches = -(-len(db_images) // DB_BATCH)
    print(f"serve: encoded {len(db_images)} images in {db_batches} batches "
          f"of {DB_BATCH} in {encode_s:.2f} s "
          f"({len(db_images) / encode_s:.0f} img/s, first batch included)")
    db = {"paths": [f"synthetic/{c}/{i}" for i, c in enumerate(db_classes)],
          "labels": [f"class_{c:04d}" for c in db_classes],
          "encodings": encodings,
          "weights_fingerprint": net.weights_fingerprint()}
    with tempfile.TemporaryDirectory() as tmp:
        net.save_encodings(db, tmp)
        net.load_encodings(f"{tmp}/encodings.pkl")
    engine = InferenceEngine(net, max_batch=MAX_BATCH)
    try:
        if not engine.ready.wait(600):
            raise TimeoutError("engine warm-up did not finish")
        answers, latencies = [], []
        for images in queries:
            t0 = time.perf_counter()
            answers.append(engine.infer_arrays(list(images)))
            latencies.append(time.perf_counter() - t0)
        launches = dict(fc.LAUNCHES)
        device_batches = db_batches + engine.device_batches
        # ---- end of the main path ----
        print(f"serve: request latencies (ms) for {sizes} images: "
              + ", ".join(f"{t * 1e3:.2f}" for t in latencies)
              + f"; engine device batches {engine.device_batches} "
                f"(warm-up included)")
        repeat = []
        for _ in range(20):
            t0 = time.perf_counter()
            engine.infer_arrays(list(queries[1]))
            repeat.append(time.perf_counter() - t0)
        print(f"serve: 32-image request, 20 repeats: median "
              f"{np.median(repeat) * 1e3:.2f} ms, min "
              f"{min(repeat) * 1e3:.2f} ms, max {max(repeat) * 1e3:.2f} ms")
    finally:
        engine.close()

    # ---- checks ----
    fused_per_forward = sum(n for _, _, n in FUSED_SHAPES)
    expected = fused_per_forward * device_batches
    if launches["conv3x3_small_bn_relu"] != expected:
        raise AssertionError(
            f"fused kernel launched {launches['conv3x3_small_bn_relu']} "
            f"times, expected {fused_per_forward} x {device_batches} device "
            f"batches = {expected}")
    db_np, label_np, classes = net._db()
    db_emb = torch.as_tensor(db_np, device=DEVICE)
    label_ids = torch.as_tensor(label_np, device=DEVICE)
    correct = total = 0
    max_emb_diff = 0.0
    served = [encodings]
    for images, truth, got in zip(queries, query_classes, answers):
        emb = direct(net, images)
        pred, _ = knn_classify(db_emb, label_ids,
                               torch.as_tensor(emb, device=DEVICE), k=5,
                               n_classes=len(classes))
        want = [classes[int(p)] for p in pred.tolist()]
        labels = [a["label"] for a in got]
        if labels != want:
            raise AssertionError(f"engine answers {labels[:8]} differ from "
                                 f"direct encode + kNN {want[:8]}")
        if not set(labels) <= set(classes):
            raise AssertionError("an answer is not a class of the DB")
        served.append(np.stack([a["embedding"] for a in got]))
        max_emb_diff = max(max_emb_diff,
                           float(np.abs(served[-1] - emb).max()))
        correct += sum(l == f"class_{t:04d}" for l, t in zip(labels, truth))
        total += len(labels)
    all_emb = np.concatenate(served)
    norms = np.linalg.norm(all_emb, axis=1)
    if not np.isfinite(all_emb).all() or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"embeddings not finite and unit norm: norms in "
                             f"[{norms.min()}, {norms.max()}]")
    accuracy = correct / total
    print(f"serve: {total} answers equal direct encode + kNN (embeddings "
          f"within {max_emb_diff:.2e}); accuracy against the true classes "
          f"{accuracy:.3f}")
    if accuracy < 0.9:
        raise AssertionError(f"kNN accuracy {accuracy} under 0.9")

    # the same weights through cuDNN (fast_conv off)
    plain = EmbeddingNet(FLAGSHIP, device=DEVICE, fast_conv=False,
                         dtype=torch.bfloat16)
    plain.module.load_state_dict(net.module.state_dict())
    sample = db_images[:DB_BATCH]
    diff = float(np.abs(plain.encode(sample) - net.encode(sample)).max())
    print(f"serve: kernel path vs cuDNN path, max abs embedding diff "
          f"{diff:.3e} (bound 2e-2)")
    if diff > 2e-2:
        raise AssertionError(f"kernel path differs from cuDNN by {diff}")
    x = torch.as_tensor(queries[1], device=DEVICE)
    with torch.inference_mode():
        fwd = {name: cuda_ms(lambda: n.embed(x), iters=20)
               for name, n in (("cudnn", plain), ("kernel", net),
                               ("cudnn_again", plain))}
    print(f"serve: B=32 device forward (embed): kernel path "
          f"{fwd['kernel']:.3f} ms, cuDNN path {fwd['cudnn']:.3f}/"
          f"{fwd['cudnn_again']:.3f} ms")
    return launches, db_images, db_classes



def _batches(sampler, images, n):
    """``n`` P-K batches of uint8 images and int32 labels, drawn on the
    host before the run (loading is set-up)."""
    out = []
    for _ in range(n):
        paths, labels = sampler.sample()
        out.append((torch.from_numpy(images[[int(p) for p in paths]]),
                    torch.from_numpy(labels)))
    return out


def _train_module(fast_conv, dtype=torch.bfloat16):
    m = FLAGSHIP["model"]
    return EmbeddingModule(
        backbone_name=m["backbone_name"], encodings_len=m["encodings_len"],
        embeddings_normalization=m["embeddings_normalization"],
        bn_momentum=BN_MOMENTUM, fast_conv=fast_conv, dtype=dtype)


def _trainer(module, dtype=torch.bfloat16, augment_fn=None,
             mode="batch_all", max_positives=K_SAMPLES - 1):
    spec = get_optimizer("adam", step_decay_schedule(LR, LR_DECAY, 1,
                                                     STEPS_PER_EPOCH))
    state = TrainState.create(module, spec)
    step = make_triplet_train_step(
        module, spec, margin=MARGIN, mode=mode, augment_fn=augment_fn,
        compute_dtype=dtype, max_positives=max_positives)
    return state, step


def _timed_steps(state, step, batches):
    """Runs the steps; (per-step wall seconds, metrics as floats)."""
    times, metrics = [], []
    for images, labels in batches:
        t0 = time.perf_counter()
        state, m = step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics


def _device_busy(state, step, batches):
    """(device-busy share, device ms per step, the port's kernels, top
    kernels, wall seconds, device ms per step under the step's "augment"
    range) over the steps, from torch.profiler."""
    prof, kernels, wall = _profile_agreed(
        _run_steps(state, step, batches), "the step's profile")
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {name: us for name, us in by_name.items()
            if "conv3x3" in name or "normalize_u8" in name}
    # the kernels launched inside the CPU-side "augment" ranges
    ranges = [e for e in prof.events() if e.name == "augment"
              and e.device_type == torch.autograd.DeviceType.CPU]
    augment_us = sum(e.device_time_total for e in ranges)

    def launches(e):
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)

    augment = {"ms": augment_us * 1e-3 / len(batches),
               "launches": sum(launches(e) for e in ranges) / len(batches),
               "host_ms": sum(e.cpu_time_total for e in ranges) * 1e-3
               / len(batches)}
    return (busy_us * 1e-6 / wall, busy_us * 1e-3 / len(batches),
            ours, top, wall, augment)


def _pk_batches(db_images, db_classes, n, seed=SEED, k_classes=P_CLASSES):
    class_files = {}
    for i, c in enumerate(db_classes):
        class_files.setdefault(f"class_{c:04d}", []).append(str(i))
    sampler = PKSampler(class_files, sorted(class_files),
                        k_classes=k_classes, k_samples=K_SAMPLES, seed=seed)
    return _batches(sampler, db_images, n)


def _check_training(label, metrics, launches, expected, steps):
    """Finite, falling loss, mined triplets, exact launches per step."""
    losses = [m["loss"] for m in metrics]
    print(f"{label}: losses " + " ".join(f"{l:.4f}" for l in losses))
    print(f"{label}: n_triplets " + " ".join(str(int(m["n_triplets"]))
                                             for m in metrics))
    print(f"{label}: launches over {steps} steps: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not all(m["n_triplets"] > 0 for m in metrics):
        raise AssertionError("a step mined no triplet")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"{label}: mean loss of the first 5 steps {first:.4f}, of the "
          f"last 5 {last:.4f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    _check_launches(label, launches, expected, steps)


def _check_launches(label, launches, expected, steps):
    """Exact launches per step on ResNet-50's training path."""
    for name, per_step in expected.items():
        if launches[name] != per_step * steps:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times over "
                f"{steps} steps, expected {per_step} per step")
    for name in RESNET50_OFF_PATH:
        if launches[name]:
            raise AssertionError(f"{label}: {name} launched on the "
                                 f"training path")


def training_phase(db_images, db_classes):
    batches = _pk_batches(db_images, db_classes, WARMUP_STEPS + TIMED_STEPS
                          + PROFILED_STEPS + 1)
    warmup = batches[:WARMUP_STEPS]
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]
    profiled = batches[WARMUP_STEPS + TIMED_STEPS:-1]
    probe = batches[-1]

    t0 = time.perf_counter()
    module = _train_module(fast_conv=True)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module.to(DEVICE)
    state, step = _trainer(module)
    _timed_steps(state, step, warmup)
    print(f"train: model built and {WARMUP_STEPS} warm-up steps in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the main path: every launch count from here to the reading ----
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    bnk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = _timed_steps(state, step, timed)
    launches = {**fc.LAUNCHES, **pre.LAUNCHES, **bnk.LAUNCHES}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    print(f"train: {TIMED_STEPS} steps of B={P_CLASSES * K_SAMPLES}, "
          f"kernel path: step median {med * 1e3:.2f} ms (min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
          f"{P_CLASSES * K_SAMPLES / med:.0f} img/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"train: last step frac_mined {metrics[-1]['frac_mined']:.4f}, "
          f"mean_pos_dist {metrics[-1]['mean_pos_dist']:.4f}, "
          f"mean_neg_dist {metrics[-1]['mean_neg_dist']:.4f}")
    _check_training("train", metrics, launches, EXPECTED_PER_STEP,
                    TIMED_STEPS)

    busy, device_ms, ours, top, wall, _ = _device_busy(state, step,
                                                       profiled)
    ours_ms = sum(ours.values()) * 1e-3 / PROFILED_STEPS
    print(f"train: torch.profiler over {PROFILED_STEPS} steps: device busy "
          f"{busy:.3f} of {wall * 1e3:.1f} ms wall (profiled), "
          f"{device_ms:.2f} ms of device time per step, "
          f"{device_ms / (med * 1e3):.3f} of the unprofiled step median; "
          f"the port's kernels {ours_ms:.2f} ms per step")
    for label, rows in (("top", top), ("port kernel", sorted(ours.items()))):
        for name, us in rows:
            print(f"  profile {label}: {us / PROFILED_STEPS / 1e3:8.3f} "
                  f"ms/step  {name[:90]}")

    # the same weights and batch through the cuDNN path (fast_conv off), in
    # bf16 and in f32
    snapshot = {k: v.clone() for k, v in module.state_dict().items()}
    plain = _train_module(fast_conv=False).to(DEVICE)
    results = {}
    for label, mod, dtype in (
            ("kernel", module, torch.bfloat16),
            ("cudnn", plain, torch.bfloat16),
            ("f32", _train_module(False, dtype=None).to(DEVICE),
             torch.float32)):
        mod.load_state_dict(snapshot)
        st, stp = _trainer(mod, dtype)
        _, (m,) = _timed_steps(st, stp, [probe])
        results[label] = (m["loss"], {n: p.grad.float().clone()
                                      for n, p in mod.named_parameters()})
        if label == "f32":
            del mod, st, stp
    losses3 = {k: v[0] for k, v in results.items()}
    grads = {k: v[1] for k, v in results.items()}
    ref = grads["f32"]

    def rel(label, names):
        num = sum(((grads[label][n] - ref[n]) ** 2).sum() for n in names)
        den = sum((ref[n] ** 2).sum() for n in names)
        return (num / den.clamp_min(1e-30)).sqrt().item()

    loss_rel = abs(losses3["kernel"] - losses3["cudnn"]) / abs(
        losses3["cudnn"])
    every = list(ref)
    total_k, total_c = rel("kernel", every), rel("cudnn", every)
    print(f"train: one step from the same weights and batch: loss kernel "
          f"{losses3['kernel']:.6f}, cuDNN {losses3['cudnn']:.6f} (relative "
          f"{loss_rel:.2e}, tolerance {LOSS_RTOL}), f32 {losses3['f32']:.6f}"
          f"; gradient relative L2 to the f32 step over all parameters: "
          f"kernel {total_k:.4f}, cuDNN {total_c:.4f} (tolerance "
          f"{GRAD_FACTOR} x cuDNN)")
    rows = []
    for n, g in ref.items():
        if g.dim() == 4:
            kc = ((grads["kernel"][n] - grads["cudnn"][n]).norm()
                  / grads["cudnn"][n].norm().clamp_min(1e-30)).item()
            rows.append((rel("kernel", [n]), rel("cudnn", [n]), kc, n))
    rows.sort(key=lambda r: r[1] * GRAD_FACTOR + GRAD_SLACK - r[0])
    for ek, ec, kc, n in rows[:5]:
        print(f"  conv weight gradient, closest to its tolerance: {n}: to "
              f"f32 kernel {ek:.4f}, cuDNN {ec:.4f}; kernel to cuDNN "
              f"{kc:.4f}")
    bad = [n for ek, ec, _, n in rows
           if ek > GRAD_FACTOR * ec + GRAD_SLACK]
    if loss_rel > LOSS_RTOL or total_k > GRAD_FACTOR * total_c or bad:
        raise AssertionError(f"the kernel path and the cuDNN path disagree "
                             f"(conv weights past tolerance: {bad})")

    # the cuDNN path's step time, in the same call
    st, stp = _trainer(plain)
    _timed_steps(st, stp, warmup[:2])
    c_times, _ = _timed_steps(st, stp, timed[:CUDNN_STEPS])
    c_med = float(np.median(c_times))
    print(f"train: cuDNN path: step median {c_med * 1e3:.2f} ms over "
          f"{CUDNN_STEPS} steps ({P_CLASSES * K_SAMPLES / c_med:.0f} img/s) "
          f"against the kernel path's {med * 1e3:.2f} ms")
    return launches


def cell_images(rng, classes, cells=CELLS, size=64):
    """uint8 images of ``classes``: each class a ``cells`` x ``cells`` grid
    of random colours scaled up to ``size``, plus per-image noise."""
    base = rng.integers(0, 256, (int(classes.max()) + 1, cells, cells, 3),
                        dtype=np.uint8)
    base = base.repeat(size // cells, 1).repeat(size // cells, 2)
    return synthetic(rng, base, classes)


def augmented_training_phase(db_classes):
    """The flagship step as its config sets it, with the ``default``
    augmentation, on images of coloured cells (CELLS): 20 timed steps with
    exact launch counts, a falling loss, the busy share, peak memory and
    the augmentation's device time. Returns the launches, the kernels'
    device times, the step's images/s and the images."""
    images = cell_images(np.random.default_rng(SEED + 3), db_classes)
    batches = _pk_batches(images, db_classes, WARMUP_STEPS
                          + AUG_TIMED_STEPS + PROFILED_STEPS, seed=SEED + 1)
    warmup = batches[:WARMUP_STEPS]
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + AUG_TIMED_STEPS]
    profiled = batches[WARMUP_STEPS + AUG_TIMED_STEPS:]

    t0 = time.perf_counter()
    module = _train_module(fast_conv=True)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module.to(DEVICE)
    state, step = _trainer(module, augment_fn=aug.augment_from_params(
        FLAGSHIP))
    if state.generator.device.type != torch.device(DEVICE).type:
        raise AssertionError("the augmentation's generator is not on the "
                             "card")
    _timed_steps(state, step, warmup)
    print(f"train+aug: model built and {WARMUP_STEPS} warm-up steps in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the main path: every launch count from here to the reading ----
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    bnk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = _timed_steps(state, step, timed)
    launches = {**fc.LAUNCHES, **pre.LAUNCHES, **bnk.LAUNCHES}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    print(f"train+aug: {AUG_TIMED_STEPS} steps of B={P_CLASSES * K_SAMPLES} "
          f"with the {AUG_PRESET!r} preset, kernel path: step median "
          f"{med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {P_CLASSES * K_SAMPLES / med:.0f} "
          f"img/s, peak memory {peak / 2 ** 30:.2f} GiB")
    print(f"train+aug: frac_mined " + " ".join(
        f"{m['frac_mined']:.3f}" for m in metrics) + "; last step "
        f"mean_pos_dist {metrics[-1]['mean_pos_dist']:.4f}, mean_neg_dist "
        f"{metrics[-1]['mean_neg_dist']:.4f}")
    _check_training("train+aug", metrics, launches,
                    {**EXPECTED_AUG_PER_STEP, **_bn_per_step(module)},
                    AUG_TIMED_STEPS)

    busy, device_ms, ours, top, wall, augment = _device_busy(state, step,
                                                             profiled)
    aug_ms = augment["ms"]
    print(f"train+aug: torch.profiler over {PROFILED_STEPS} steps: device "
          f"busy {busy:.3f} of {wall * 1e3:.1f} ms wall (profiled), "
          f"{device_ms:.2f} ms of device time per step, "
          f"{device_ms / (med * 1e3):.3f} of the unprofiled step median; "
          f"augmentation {aug_ms:.3f} ms of device time per step in "
          f"{augment['launches']:.0f} kernel launches, its range "
          f"{augment['host_ms']:.2f} ms of host time (profiled); the "
          f"port's kernels {sum(ours.values()) * 1e-3 / PROFILED_STEPS:.2f} "
          f"ms per step")
    for name, us in top:
        print(f"  profile top: {us / PROFILED_STEPS / 1e3:8.3f} ms/step  "
              f"{name[:90]}")
    for name, us in sorted(ours.items()):
        print(f"  profile port kernel: {us / PROFILED_STEPS / 1e3:8.3f} "
              f"ms/step  {name[:90]}")
    if aug_ms <= 0:
        raise AssertionError("the profiler saw no augmentation kernels")
    device = {name: sum(us for n, us in ours.items()
                        if all(p in n for p in parts)) * 1e-3 / PROFILED_STEPS
              for name, parts in PROFILED_NAMES.items()}
    device[PART_SUM_NAME] = sum(us for n, us in ours.items()
                                if PART_SUM_NAME in n) * 1e-3 / PROFILED_STEPS
    missing = [n for n in PER_STEP if not device[n]]
    if missing:
        raise AssertionError(f"the profiler saw no device time of {missing}")
    return launches, device, P_CLASSES * K_SAMPLES / med, images


def _write_fit_dataset(root, n_classes=FIT_CLASSES, per_class=FIT_PER_CLASS,
                       size=64):
    """A fit's folder dataset: ``n_classes`` classes of ``per_class`` PNGs
    of 8x8 colour cells (as phase 8's) at ``size`` px, written with cv2 on
    8 threads."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor
    classes = np.repeat(np.arange(n_classes), per_class)
    images = cell_images(np.random.default_rng(SEED + 5), classes, size=size)

    def write(i):
        d = os.path.join(root, f"class_{classes[i]:04d}")
        os.makedirs(d, exist_ok=True)
        if not cv2.imwrite(os.path.join(d, f"{i % per_class}.png"),
                           images[i]):
            raise OSError(f"cv2 could not write image {i}")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(classes))))
    return images


def _fit_config(tmp, source=FIT_CONFIG, cuts=FIT_CUTS, settings=(),
                label="fit", work="work", name="config.yml", values=None):
    """A config with a phase's cuts (``cuts``: (section, key, value, why),
    printed as ``reduced`` lines) and settings (``settings``: (section, key,
    value), what the phase exercises, printed as ``set`` lines), written as
    a YAML file for the port's parse_params and the CLI; the dataset is
    ``tmp/dataset``, the work dir ``tmp/<work>``, and ``values`` gives the
    other keys whose cut is a path of the phase."""
    import yaml
    with open(source) as f:
        cfg = yaml.safe_load(f)
    values = {"dataset_path": os.path.join(tmp, "dataset"),
              "work_dir": os.path.join(tmp, work), **(values or {})}
    changes = [(s, k, v, "reduced", f" ({why})") for s, k, v, why in cuts]
    changes += [(s, k, v, "set", "") for s, k, v in settings]
    for section, key, value, verb, why in changes:
        value = values.get(key, value)
        cfg[section] = dict(cfg.get(section) or {})
        print(f"{label}: {verb} {section}.{key}: "
              f"{cfg[section].get(key, 'unset')!r} -> {value!r}{why}")
        cfg[section][key] = value
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _same(a, b, path):
    """Bit-for-bit equality of two nested state dicts, tensors compared on
    the host."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"resume: {path} keys differ")
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"resume: {path} lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"resume: {path} differs from the checkpoint")
    elif a != b:
        raise AssertionError(f"resume: {path} {a!r} != {b!r}")


def _fit_pace(trainer, label="fit pace"):
    """Who sets the train epoch's pace, with the decode cache warm where
    the config has one: the loader alone (sampling, decode or cache reads,
    pinning, the copies) over one epoch's batches; one more train epoch
    unprofiled, for its wall, its images_per_sec and its wait for batches;
    then a third under torch.profiler for its device time only, which is
    divided by the unprofiled wall (as phase 8 does), since the profiler's
    own host cost per launch stretches the wall it runs in."""
    from torch.profiler import ProfilerActivity, profile
    trainer._current_epoch = 0       # epoch 0's batches: all cached
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for images, _ in trainer._device_prefetch(trainer._train_loader()):
        n += sum(int(x.shape[0]) for x in (
            images if isinstance(images, tuple) else (images,)))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = trainer._run_train_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wait = trainer._data_wait_s
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._run_train_epoch()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    cache = "cache warm" if trainer._decode_cache is not None else "no cache"
    print(f"{label}: the loader alone, {cache}: {n} images in "
          f"{load_s:.3f} s ({n / load_s:.0f} img/s, pinned copies included); "
          f"a warm train epoch unprofiled: {wall:.3f} s, images_per_sec "
          f"{metrics['images_per_sec']:.0f}, waiting {wait:.3f} s for "
          f"batches; the next under torch.profiler ({prof_wall:.3f} s): "
          f"device busy {busy_us * 1e-6:.3f} s, {busy_us * 1e-6 / wall:.3f} "
          f"of the unprofiled wall")


def fit_phase(smi, step_images_per_s, tmp):
    """The flagship fit through the port's Trainer (phase 9), in the temp
    dir ``tmp``: two epochs with the val epoch, recall, plateau and the
    best checkpoint, exact launch counts; then resume from epoch 0 in a
    second Trainer and the CLI (resuming the latest checkpoint) with its
    export, whose base model encodes like the CLI's Trainer. Returns the
    fit's launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train import checkpoint as ckpt
    from embeddingnet_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    images = _write_fit_dataset(os.path.join(tmp, "dataset"))
    print(f"fit: wrote {len(images)} PNGs of {FIT_CLASSES} classes in "
          f"{time.perf_counter() - t0:.1f} s")
    path = _fit_config(tmp)
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    t0 = time.perf_counter()
    trainer = Trainer(params, loader, device=DEVICE)
    print(f"fit: Trainer built in {time.perf_counter() - t0:.1f} s")

    g, t = params.generator, params.train
    n_db = sum(min(len(v), t.eval_recall_max_per_class)
               for v in loader.train_data.values())
    n_val = len(loader.flat("val")[0])
    chunks = -(-n_db // 256) + -(-n_val // 256)
    steps = t.n_epochs * g.n_batches
    val_forwards = t.n_epochs * g.n_batches_val
    evals = t.n_epochs // t.eval_recall_every
    per_step = EXPECTED_AUG_PER_STEP
    expected = {name: per_step[name] * steps for name in per_step}
    k3 = "conv3x3_small_bn_relu"
    expected[k3] += per_step[k3] * (val_forwards + evals * chunks)
    expected["normalize_u8"] = val_forwards

    # ---- the fit's path: every launch count from here to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = trainer.fit().history
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the fit's path ----
    peak = torch.cuda.max_memory_allocated()
    CV2_NUMBERS["fit"] = {"epoch_s": [t["epoch_s"] for t in trainer.timings],
                          "images_per_sec": list(history["images_per_sec"]),
                          "backend": trainer._train_loader().backend}
    for timing, ips in zip(trainer.timings, history["images_per_sec"]):
        print(f"fit: epoch {timing['epoch']}: {timing['epoch_s']:.2f} s "
              f"(train {timing['train_s']:.2f}, val epoch "
              f"{timing['val_s']:.2f}, recall {timing['recall_s']:.2f}, "
              f"checkpoint {timing['checkpoint_s']:.2f} s, "
              f"{timing['checkpoint_bytes'] / 2 ** 20:.1f} MiB; the "
              f"train epoch waited {timing['data_wait_s']:.2f} s for "
              f"batches); "
              f"Trainer images_per_sec {ips:.0f} against phase 8's "
              f"bare step {step_images_per_s:.0f} img/s [{smi}]")
    print(f"fit: {t.n_epochs} epochs of {g.n_batches} steps at "
          f"B={g.k_classes * g.k_samples} in {fit_s:.2f} s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; " + "; ".join(
              f"{k} " + " ".join(f"{v:.4f}" for v in vals)
              for k, vals in history.items()))
    print(f"fit: launches over the fit: {launches}; expected "
          f"{expected} ({steps} train steps, {val_forwards} val "
          f"forwards of {3 * g.batch_size}, {evals} recall evals of "
          f"{chunks} chunks: {n_db} DB and {n_val} val images)")
    for key in ("loss", "val_loss"):
        if not np.all(np.isfinite(history[key])):
            raise AssertionError(f"fit: {key} not finite: {history[key]}")
    for key in ("val_recall1", "val_recall5"):
        if not all(0.0 <= v <= 1.0 for v in history[key]):
            raise AssertionError(f"fit: {key} outside [0, 1]")
        if len(history[key]) != evals:
            raise AssertionError(f"fit: {key} missing")
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"fit: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    for name in RESNET50_OFF_PATH:
        if launches[name]:
            raise AssertionError(f"fit: {name} launched on the fit")

    # the best epoch's checkpoint
    vals = history[trainer.ckpt_mgr.monitor]
    best = int(np.argmin(vals))
    saved_path = os.path.join(trainer.paths["weights"], str(best),
                              ckpt.STATE_FILE)
    if (trainer.ckpt_mgr.latest_epoch() != best
            or not os.path.exists(saved_path)):
        raise AssertionError(f"fit: no checkpoint of the best epoch "
                             f"{best} ({trainer.ckpt_mgr.epochs()})")
    print(f"fit: best epoch {best} by {trainer.ckpt_mgr.monitor}, "
          f"checkpoint {os.path.getsize(saved_path) / 2 ** 20:.1f} MiB")
    _fit_pace(trainer)

    _resume_check("fit", params, loader, trainer)
    del trainer

    _cli_export("fit", path, params, images[:256])
    return launches


def _resume_check(label, params, loader, trainer):
    """A second Trainer resumes ``trainer``'s epoch 0 and must hold its
    checkpoint bit for bit."""
    from embeddingnet_tpu_torch.train import checkpoint as ckpt
    from embeddingnet_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    second = Trainer(params, loader, device=DEVICE, log_fn=lambda *a: None)
    second.resume(0)
    resume_s = time.perf_counter() - t0
    if second.start_epoch != 1:
        raise AssertionError(f"{label}: resume: start_epoch "
                             f"{second.start_epoch}")
    saved = torch.load(os.path.join(trainer.paths["weights"], "0",
                                    ckpt.STATE_FILE),
                       map_location=DEVICE, weights_only=True)
    restored = second.state.state_dict()
    for key in ("module", "optimizer", "generator", "step",
                "plateau_scale"):
        _same(restored[key], saved[key], key)
    if second.state.generator.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"{label}: resume: the generator is not on the "
                             f"card")
    print(f"{label}: a second Trainer resumed epoch 0 in {resume_s:.2f} s "
          f"(built and loaded): module, optimizer, generator, step and "
          f"plateau scale bit for bit, start_epoch 1")


def _cli_export(label, path, params, batch):
    """The CLI on the config at ``path``: resume the latest checkpoint, fit
    what is left, export; the exported base model, reloaded, must encode
    ``batch`` within bf16 rounding of the CLI's Trainer's recall encoder
    (the weights it exports, L2-normalised in arcface mode)."""
    from embeddingnet_tpu_torch.models.api import EmbeddingNet as Net
    from embeddingnet_tpu_torch.train.steps import make_eval_step
    t0 = time.perf_counter()
    cli = runpy.run_path(TRAIN_CLI)["main"]
    cli_trainer, net = cli([path, "--device", DEVICE, "--resume_from",
                            "latest"])
    cli_s = time.perf_counter() - t0
    work = cli_trainer.paths["work_dir"]
    reloaded = Net(params, device=DEVICE, fast_conv=True,
                   dtype=cli_trainer.compute_dtype).load_model(
        os.path.join(work, "base_model.pt"))
    got = reloaded.encode(batch)
    want = make_eval_step(cli_trainer._recall_encoder(), compute_dtype=(
        cli_trainer.compute_dtype))(cli_trainer.state, torch.from_numpy(
            batch)).cpu().numpy()
    err = float(np.abs(got - want).max())
    print(f"{label}: the CLI resumed, fitted, exported in {cli_s:.1f} s; "
          f"its base model reloaded encodes {len(batch)} images within "
          f"{err:.2e} of its Trainer's encoder (tolerance bf16 {ATOL}); "
          f"encodings {os.path.getsize(os.path.join(work, 'encodings', 'encodings.pkl')) / 2 ** 20:.1f} MiB")
    _check(f"{label}: CLI export", torch.from_numpy(got),
           torch.from_numpy(want), ATOL, RTOL)


def _shuffled(batches, seed):
    """The batches with their rows in a random order: the labels leave
    their P-K groups."""
    rng = np.random.default_rng(seed)
    out = []
    for images, labels in batches:
        order = torch.from_numpy(rng.permutation(len(labels)))
        out.append((images[order], labels[order]))
    return out


def _mining_device_ms(module, state, images, labels, mode, max_positives):
    """Device time of the miner alone, forward and backward, on the
    embeddings of ``images`` (an eval forward of the step's module), its
    draws from a generator on the card; torch.profiler's kernel time."""
    from embeddingnet_tpu_torch.ops import mining
    from embeddingnet_tpu_torch.train.steps import make_eval_step
    emb = make_eval_step(module, compute_dtype=torch.bfloat16)(state, images)
    labels = labels.to(DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(SEED)

    def run():
        e = emb.detach().requires_grad_()
        loss, _ = mining.mined_triplet_loss(
            e, labels, margin=MARGIN, mode=mode, rng=generator,
            max_positives=max_positives)
        loss.backward()
    return device_ms(run)


def _exact_embeddings(b, d=256, seed=SEED):
    """[b, d] f32 embeddings on a grid of 1/256 within +-0.5: every product
    and partial sum of the squared distances is exact in float32, so the
    card and the CPU compute the same distances in any order."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=(b, d)) * 0.12, -0.5, 0.5)
    return (np.round(x * 256) / 256).astype(np.float32)


def _mine_on(device, mode, emb, labels, draws, max_positives):
    """(loss, stats, embedding gradient, selections) of ``mode`` on
    ``device``, on the host: the rank-window miners' ``aux``, the
    enumeration's selected pairs and their negatives."""
    from embeddingnet_tpu_torch.ops import mining
    e = torch.from_numpy(emb).to(device).requires_grad_()
    lab = torch.from_numpy(labels).to(device)
    d = None if draws is None else draws.to(device)
    loss, stats = mining.mined_triplet_loss(
        e, lab, margin=MARGIN, mode=mode, draws=d,
        max_positives=max_positives)
    loss.backward()
    b = len(labels)
    sel = {}
    if mode in PARITY_MODES and b > 256:
        k = None if max_positives is None else max_positives + 1
        aux = mining._parity_forward_large(e.detach(), lab, MARGIN, mode, d,
                                           k)[3]
        sel = {n: v.cpu() for n, v in aux.items() if v is not None}
    elif mode in PARITY_MODES:
        dist = mining.pairwise_sq_l2(e.detach()).sqrt()
        _, _, _, chosen, n_star = mining._parity_select(dist, lab, MARGIN,
                                                        mode, d)
        sel = {"selected": chosen.cpu(),
               "n_star": torch.where(chosen, n_star, -1).cpu()}
    return loss.item(), [float(v) for v in stats], e.grad.cpu(), sel


def mining_card_check():
    """Each mode on each of its paths on the card against the port's CPU
    run of the same function, on one fixed exact-distance batch with the
    same draws: selections identical, loss, stats and gradient within
    MINING_RTOL."""
    from embeddingnet_tpu_torch.ops import mining
    for path, b, grouped, modes in MINING_RUNS:
        emb = _exact_embeddings(b)
        labels = np.repeat(np.arange(b // K_SAMPLES), K_SAMPLES)
        max_positives = K_SAMPLES - 1
        if not grouped:
            order = np.random.default_rng(SEED + 9).permutation(b)
            emb, labels, max_positives = emb[order], labels[order], None
        for mode in modes:
            draws = mining.sample_draws(mode, b, max_positives,
                                        torch.Generator().manual_seed(SEED))
            got = _mine_on(DEVICE, mode, emb, labels, draws, max_positives)
            want = _mine_on("cpu", mode, emb, labels, draws, max_positives)
            loss_rel = abs(got[0] - want[0]) / abs(want[0])
            stat_rel = max(abs(g - w) / max(abs(w), 1e-30)
                           for g, w in zip(got[1], want[1]))
            grad_rel = ((got[2] - want[2]).abs().max()
                        / want[2].abs().max()).item()
            same = {n: torch.equal(got[3][n], want[3][n]) for n in want[3]}
            print(f"mining check {path} B={b} {mode}: loss {got[0]:.6f} "
                  f"(CPU {want[0]:.6f}, relative {loss_rel:.2e}), stats "
                  f"relative {stat_rel:.2e}, gradient {grad_rel:.2e} of its "
                  f"largest entry (tolerance {MINING_RTOL}); n_triplets "
                  f"{int(got[1][0])}; selections identical: {same}")
            if (loss_rel > MINING_RTOL or stat_rel > MINING_RTOL
                    or grad_rel > MINING_RTOL or not all(same.values())
                    or got[3].keys() != want[3].keys() or got[1][0] <= 0):
                raise AssertionError(f"mining {path} {mode}: the card and "
                                     f"the CPU disagree")


def mining_phase(smi, images, db_classes):
    """Phase 10: the flagship step (ResNet-50, the ``default``
    augmentation) with each mining mode on each of its paths: step time,
    images/s, the miner's device time, the mined counts, exact launches;
    then the miner on the card against the CPU. Returns one row per run."""
    augment_fn = aug.augment_from_params(FLAGSHIP)
    module = _train_module(fast_conv=True)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module.to(DEVICE)
    rows = []
    for path, b, grouped, modes in MINING_RUNS:
        batches = _pk_batches(images, db_classes, MINING_WARMUP
                              + MINING_TIMED, seed=SEED + 7,
                              k_classes=b // K_SAMPLES)
        max_positives = K_SAMPLES - 1 if grouped else None
        if not grouped:
            batches = _shuffled(batches, SEED + 8)
        for mode in modes:
            label = f"mining {path} B={b} {mode}"
            state, step = _trainer(module, augment_fn=augment_fn, mode=mode,
                                   max_positives=max_positives)
            _timed_steps(state, step, batches[:MINING_WARMUP])
            # ---- this run's path: every launch count from here to the
            # reading
            fc.reset_launch_counts()
            pre.reset_launch_counts()
            times, metrics = _timed_steps(state, step,
                                          batches[MINING_WARMUP:])
            launches = {**fc.LAUNCHES, **pre.LAUNCHES}
            # ---- end of this run's path ----
            _check_launches(label, launches, EXPECTED_AUG_PER_STEP,
                            MINING_TIMED)
            losses = [m["loss"] for m in metrics]
            if not all(np.isfinite(losses)) or not all(
                    m["n_triplets"] > 0 for m in metrics):
                raise AssertionError(f"{label}: a loss is not finite or a "
                                     f"step mined nothing: {metrics}")
            med = float(np.median(times))
            row = {"path": path, "B": b, "mode": mode,
                   "step_ms": med * 1e3, "step_min_ms": min(times) * 1e3,
                   "step_max_ms": max(times) * 1e3,
                   "images_per_s": b / med,
                   "mining_device_ms": _mining_device_ms(
                       module, state, *batches[-1], mode, max_positives),
                   "n_triplets": float(np.mean([m["n_triplets"]
                                                for m in metrics])),
                   "frac_mined": float(np.mean([m["frac_mined"]
                                                for m in metrics]))}
            rows.append(row)
            print(f"{label}: step median {row['step_ms']:.2f} ms (min "
                  f"{row['step_min_ms']:.2f}, max {row['step_max_ms']:.2f})"
                  f" over {MINING_TIMED} steps, {row['images_per_s']:.0f} "
                  f"img/s; the miner forward and backward "
                  f"{row['mining_device_ms']:.3f} ms of device time; "
                  f"n_triplets {row['n_triplets']:.1f}, frac_mined "
                  f"{row['frac_mined']:.4f}; losses "
                  + " ".join(f"{l:.4f}" for l in losses) + f" [{smi}]")
    mining_card_check()
    return rows


def warmup_fit_phase(tmp):
    """Phase 10's fit: the flagship config at phase 9's cuts, 2 steps an
    epoch, one semihard warm-up epoch before batch_hard, on phase 9's
    dataset in ``tmp``. The Trainer must log the switch at epoch 1."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    path = _fit_config(tmp, cuts=WARMUP_FIT_CUTS,
                       settings=WARMUP_FIT_SETTINGS, label="warm-up fit",
                       work="work_warmup", name="warmup.yml")
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    lines = []

    def log(line):
        lines.append(line)
        print(f"warm-up fit: {line}")

    trainer = Trainer(params, loader, device=DEVICE, log_fn=log)
    t0 = time.perf_counter()
    history = trainer.fit().history
    torch.cuda.synchronize()
    print(f"warm-up fit: {params.train.n_epochs} epochs in "
          f"{time.perf_counter() - t0:.1f} s; n_triplets per epoch "
          f"{history['n_triplets']}, frac_mined {history['frac_mined']}")
    if [l for l in lines if "mining mode" in l] != [WARMUP_SWITCH]:
        raise AssertionError("warm-up fit: the Trainer did not switch from "
                             "semihard to batch_hard at epoch 1")
    if trainer._mining_mode != "batch_hard" or not np.all(
            np.isfinite(history["loss"])):
        raise AssertionError(f"warm-up fit: mode {trainer._mining_mode}, "
                             f"losses {history['loss']}")


def siamese_phase(smi, tmp):
    """Phase 11: configs/siamese_resnet18_pairs.yml fitted through the
    port's Trainer (cut as SIAMESE_CUTS prints) on PNGs written to
    ``tmp/siamese``: loss and accuracy per epoch, exact launches predicted
    from the gate, the best checkpoint, a resumed second Trainer and the
    CLI's export. Returns the fit's launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    root = os.path.join(tmp, "siamese")
    t0 = time.perf_counter()
    images = _write_fit_dataset(os.path.join(root, "dataset"),
                                SIAMESE_CLASSES)
    print(f"siamese: wrote {len(images)} PNGs of {SIAMESE_CLASSES} classes "
          f"in {time.perf_counter() - t0:.1f} s")
    path = _fit_config(root, source=SIAMESE_CONFIG, cuts=SIAMESE_CUTS,
                       label="siamese")
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device=DEVICE)
    g, t = params.generator, params.train
    steps, vals = t.n_epochs * g.n_batches, t.n_epochs * g.n_batches_val
    expected = {name: SIAMESE_PER_STEP.get(name, 0) * steps
                + SIAMESE_PER_VAL.get(name, 0) * vals
                for name in {**fc.LAUNCHES, **pre.LAUNCHES}}
    print(f"siamese: predicted launches over the fit ({steps} train steps "
          f"of {g.batch_size} pairs, {vals} val batches): {expected}")

    # ---- the siamese fit's path: every launch count from here to the
    # reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.fit().history
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the siamese fit's path ----
    for e in range(len(history["loss"])):
        print(f"siamese: epoch {e}: " + ", ".join(
            f"{k} {history[k][e]:.4f}" for k in (
                "loss", "accuracy", "val_loss", "val_accuracy",
                "images_per_sec")) + f" [{smi}]")
    print(f"siamese: {t.n_epochs} epochs in {fit_s:.1f} s; launches "
          f"{launches}")
    for key in ("loss", "val_loss"):
        if not np.all(np.isfinite(history[key])):
            raise AssertionError(f"siamese: {key} not finite")
    for key in ("accuracy", "val_accuracy"):
        if not all(0.0 <= v <= 1.0 for v in history[key]):
            raise AssertionError(f"siamese: {key} outside [0, 1]")
    if launches != expected:
        raise AssertionError(f"siamese: launches {launches}, predicted "
                             f"{expected}")
    if trainer.ckpt_mgr.latest_epoch() is None:
        raise AssertionError("siamese: no checkpoint")
    _fit_pace(trainer, "siamese pace")
    _resume_check("siamese", params, loader, trainer)
    del trainer
    _cli_export("siamese", path, params, images[:64])
    return launches


def _arcface_from_config(path, label, batch=None, tp=None, parallel=None):
    """The ArcFace module, train state and step that the Trainer builds
    for the config at ``path`` (its backbone, widths, margin, optimizer,
    schedule, EMA, augmentation and compute dtype), over VIT_CLASSES
    classes, random weights drawn on the card from SEED; ``batch``
    overrides the config's. Prints what it takes as ``set`` lines and what
    it leaves as ``reduced`` lines. ``tp`` splits the module over a model
    group before the state is built, ``parallel`` is the step's data
    group."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    from embeddingnet_tpu_torch.train.steps import make_arcface_train_step
    params = parse_params(path)
    m, g, t, perf = (params.model, params.generator, params.train,
                     params.performance)
    dtype = (torch.bfloat16 if perf.compute_dtype == "bfloat16"
             else torch.float32)
    batch = batch or g.batch_size
    print(f"{label}: set from {os.path.relpath(path)}: {m.backbone_name}, "
          f"input {list(m.input_shape)}, {m.encodings_len}-d, B={batch}, "
          f"margin {g.margin}, {t.optimizer} lr {t.learning_rate} "
          f"(warm-up {t.warmup_epochs} epoch of {g.n_batches} steps, decay "
          f"{t.decay_factor}, weight decay "
          f"{t.weight_decay if t.optimizer == 'adamw' else None}), EMA "
          f"{perf.ema_decay}, augmentation {g.augmentations!r}, "
          f"{perf.compute_dtype}")
    print(f"{label}: reduced DATALOADER.dataset_path: {VIT_CLASSES} classes "
          f"of synthetic colour cells (no data on the machine); "
          f"PERFORMANCE.remat: {perf.remat!r} -> not ported (activations "
          f"kept)")
    module = ArcFaceModule(m.backbone_name, encodings_len=m.encodings_len,
                           n_classes=VIT_CLASSES, dtype=dtype,
                           input_shape=m.input_shape).to(DEVICE)
    module.reset_parameters(torch.Generator(DEVICE).manual_seed(SEED))
    shard_module(module, tp)
    kw = {"weight_decay": t.weight_decay} if t.optimizer == "adamw" else {}
    spec = get_optimizer(t.optimizer, step_decay_schedule(
        t.learning_rate, t.decay_factor, t.step_size, g.n_batches,
        warmup_epochs=t.warmup_epochs), **kw)
    state = TrainState.create(
        module, spec, generator=torch.Generator(DEVICE).manual_seed(SEED + 1),
        ema_decay=perf.ema_decay)
    step = make_arcface_train_step(
        module, spec, n_classes=VIT_CLASSES, margin=g.margin,
        augment_fn=aug.get_aug(g.augmentations), compute_dtype=dtype,
        parallel=parallel)
    n_params = sum(p.numel() for p in module.parameters())
    flops = _vit_flops(m.backbone_name, m.input_shape, m.encodings_len,
                       VIT_CLASSES)
    return (module, state, step, batch, tuple(m.input_shape), n_params,
            flops)


def _vit_flops(backbone, input_shape, encodings_len, n_classes):
    """(FLOPs of one image's training step, of which attention's score and
    value products): the forward's multiply-adds from the shapes (patch
    embedding, each block's projections, products and MLP, the projection,
    the head and the ArcFace cosines), times 2 for a multiply-add and 3
    for the forward and the backward."""
    from embeddingnet_tpu_torch.models import vit
    kw = vit._VARIANTS[backbone]
    p, d, depth, heads = kw["patch"], kw["dim"], kw["depth"], kw["heads"]
    h, w, c = input_shape
    n = (h // p) * (w // p)
    tokens = n + 1
    out = kw.get("proj_dim") or d
    attention = depth * 2 * tokens * tokens * d
    macs = (n * p * p * c * d + attention
            + depth * (tokens * d * 3 * d + tokens * d * d
                       + 2 * tokens * d * 4 * d)
            + (tokens * d * out if kw.get("proj_dim") else 0)
            + out * encodings_len // 2 + encodings_len ** 2 // 2
            + encodings_len * n_classes)
    return 6 * macs, 6 * attention


def _vit_batches(shape, batch, n, seed):
    """``n`` uniform batches of colour-cell images (a pool of VIT_POOL
    images of VIT_CLASSES classes) and their labels, on the card."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, VIT_CLASSES, VIT_POOL)
    pool = cell_images(rng, classes, size=shape[0])
    out = []
    for _ in range(n):
        idx = rng.integers(0, VIT_POOL, batch)
        out.append((torch.from_numpy(pool[idx]).to(DEVICE),
                    torch.from_numpy(classes[idx]).to(DEVICE)))
    return out


def _vit_profile(state, step, batches):
    """torch.profiler over ``batches``: the device ms per step, the busy
    share of the wall, the ten kernels and the ten host-side ops with the
    most device time of their own, and the VIT_SHARES of the device
    time."""
    prof, kernels, wall = _profile_agreed(
        _run_steps(state, step, batches), "the ViT step's profile")
    busy_us = sum(e.device_time_total for e in kernels)
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total
    by_op = {e.key: e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.self_device_time_total > 0}
    n = len(batches)
    return {"device_ms": busy_us * 1e-3 / n, "busy": busy_us * 1e-6 / wall,
            "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])
            [:10], "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])
            [:10], "top_ops_ms": {k: us * 1e-3 / n for k, us in by_op.items()},
            "n": n, **{
                name: sum(by_op.get(k, 0.0) for k in ops) / busy_us
                for name, ops in VIT_SHARES.items()}}


def _att_layers(module):
    """The attention cores of ``module``: one call each a forward."""
    from embeddingnet_tpu_torch.models import vit
    return sum(isinstance(m, vit.MultiHeadDotProductAttention)
               for m in module.modules())


def _att_reset():
    """Zeroes the attention kernels' launch counts at the start of a ViT
    path; returns the ViT's core calls so far, for :func:`_att_read`."""
    from embeddingnet_tpu_torch.models import vit
    att.reset_launch_counts()
    return vit.LAUNCHES["attention"]


def _att_read(label, cores_before, bwd=None, plain=0):
    """The attention launches of a ViT path since :func:`_att_reset`, kept
    in ATT_LAUNCHES under ``label``. Raises unless every core call but
    ``plain`` (the CPU's) launched the forward kernel, ``plain`` took the
    plain version and the backward launched ``bwd`` times (None: once a
    core call, every forward differentiated once)."""
    from embeddingnet_tpu_torch.models import vit
    cores = vit.LAUNCHES["attention"] - cores_before
    got = dict(att.LAUNCHES)
    want = {"fwd": cores - plain, "bwd": cores if bwd is None else bwd,
            "plain": plain}
    print(f"{label}: attention launches {got} for {cores} core calls, "
          f"predicted {want}")
    if got != want or not got["fwd"]:
        raise AssertionError(f"{label}: attention launches {got}, "
                             f"predicted {want}")
    ATT_LAUNCHES[label] = got
    return got


def vit_step_phase(smi, label, path, warmup, timed, batch=None):
    """Phase 12 (a) and (b): the config's ArcFace step at full width and
    depth: warm-up, timed steps with every port kernel's launches counted
    (all must stay 0: a ViT has no 3x3 conv, and the augmented step
    divides in f32), the median, images/s, peak memory, then the profiled
    steps' device time, busy share, top kernels and ops and the attention
    and LayerNorm/activation shares."""
    t0 = time.perf_counter()
    module, state, step, batch, shape, n_params, (flops, attn_flops) = (
        _arcface_from_config(path, label, batch))
    batches = _vit_batches(shape, batch, warmup + timed + VIT_PROFILED,
                           SEED + 7)
    _timed_steps(state, step, batches[:warmup])
    print(f"{label}: {n_params / 1e6:.1f} M parameters; built and "
          f"{warmup} warm-up steps in {time.perf_counter() - t0:.1f} s")
    # ---- the step's path: every launch count from here to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    cores = _att_reset()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = _timed_steps(state, step,
                                  batches[warmup:warmup + timed])
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    _att_read(label, cores, bwd=_att_layers(module) * timed)
    # ---- end of the step's path ----
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    losses = [m["loss"] for m in metrics]
    step_flops = flops * batch
    print(f"{label}: {timed} steps of B={batch}: median {med * 1e3:.2f} ms "
          f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
          f"{batch / med:.0f} img/s, peak memory {peak / 2 ** 30:.2f} GiB "
          f"[{smi}]")
    print(f"{label}: {step_flops / 1e12:.2f} TFLOP a step from the shapes "
          f"({attn_flops * batch / 1e12:.3f} of them attention's score and "
          f"value products), {step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at "
          f"the dense bf16 peak; {step_flops / med / 1e12:.1f} TFLOP/s at "
          f"the median")
    print(f"{label}: losses " + " ".join(f"{l:.4f}" for l in losses))
    print(f"{label}: port kernel launches over the timed steps: {launches}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{label}: a port kernel launched on the ViT "
                             f"path: {launches}")
    prof = _vit_profile(state, step, batches[warmup + timed:])
    print(f"{label}: torch.profiler over {prof['n']} steps: "
          f"{prof['device_ms']:.2f} ms of device time per step, busy "
          f"{prof['busy']:.3f} of the profiled wall, "
          f"{prof['device_ms'] / (med * 1e3):.3f} of the unprofiled "
          f"median; attention's products and softmax "
          f"{prof['attention']:.3f} of the device time, LayerNorm and the "
          f"activations {prof['norm_act']:.3f}, all matmuls "
          f"{prof['matmul']:.3f}, copies {prof['copy']:.3f}")
    # attention's products are the only aten::bmm; every other FLOP is
    # counted as the other matmuls'
    bmm_ms = prof["top_ops_ms"].get("aten::bmm", 0.0)
    other_ms = prof["matmul"] * prof["device_ms"] - bmm_ms
    if bmm_ms and other_ms > 0:
        print(f"{label}: attention's products {bmm_ms:.2f} ms of device "
              f"time per step, {attn_flops * batch / bmm_ms / 1e9:.1f} "
              f"TFLOP/s; the other matmuls {other_ms:.2f} ms, "
              f"{(flops - attn_flops) * batch / other_ms / 1e9:.1f} TFLOP/s")
    for name, us in prof["top_ops"]:
        print(f"  profile top op: {us / prof['n'] / 1e3:8.3f} ms/step  "
              f"{name}")
    for name, us in prof["top_kernels"]:
        print(f"  profile top kernel: {us / prof['n'] / 1e3:8.3f} ms/step  "
              f"{name[:90]}")
    del module, state, step, batches
    torch.cuda.empty_cache()


def vit_card_check():
    """Phase 12 (c): small ViTs of each family under an ArcFaceModule, f32
    with TF32 off, on the card (the attention kernels' float32 instances)
    against the CPU (the plain version) from the same weights and images:
    the embeddings, the ArcFace loss and every gradient."""
    import copy
    from embeddingnet_tpu_torch.models import vit
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    from embeddingnet_tpu_torch.ops.losses import arcface_loss
    rng = np.random.default_rng(SEED + 9)
    images = torch.from_numpy(rng.uniform(0, 1, (16, 64, 64, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 37, 16))
    for name, small in VIT_SMALL.items():
        saved = vit._VARIANTS[name]
        vit._VARIANTS[name] = small
        try:
            cpu = ArcFaceModule(name, encodings_len=64, n_classes=37,
                                input_shape=(64, 64, 3))
        finally:
            vit._VARIANTS[name] = saved
        cpu.reset_parameters(torch.Generator().manual_seed(SEED))
        card = copy.deepcopy(cpu).to(DEVICE)
        out = {}
        cores = _att_reset()
        for where, module in (("cpu", cpu), ("card", card)):
            emb, w = module(images.to("cpu" if where == "cpu" else DEVICE))
            loss = arcface_loss(emb, labels.to(emb.device), w, margin=0.5,
                                scale=64.0)
            loss.backward()
            out[where] = (emb.detach().cpu(), loss.item(),
                          {n: p.grad.cpu() for n, p in
                           module.named_parameters()})
        _att_read(f"vit card check {name}", cores, bwd=small["depth"],
                  plain=small["depth"])
        (e_cpu, l_cpu, g_cpu), (e_card, l_card, g_card) = (out["cpu"],
                                                            out["card"])
        worst = {"embeddings": ((e_card - e_cpu).abs().max()
                                / e_cpu.abs().max()).item(),
                 "loss": abs(l_card - l_cpu) / abs(l_cpu)}
        top = max(g.abs().max().item() for g in g_cpu.values())
        for n, g in g_cpu.items():
            scale = top if n.endswith(".attn.key.bias") else \
                g.abs().max().item()
            worst[n] = (g_card[n] - g).abs().max().item() / scale
        key = max(worst, key=worst.get)
        print(f"vit card check {name} (small: {small}): embeddings "
              f"{worst['embeddings']:.2e}, loss {l_card:.6f} against "
              f"{l_cpu:.6f} ({worst['loss']:.2e}), worst of "
              f"{len(g_cpu)} gradients {key} {worst[key]:.2e}; tolerance "
              f"{VIT_CARD_TOL:g} of each tensor's largest entry")
        if not all(np.isfinite(list(worst.values()))) or \
                worst[key] > VIT_CARD_TOL:
            raise AssertionError(f"vit card check {name}: {key} off by "
                                 f"{worst[key]:.2e}")


def vit_fit_phase(smi, tmp):
    """Phase 12 (d) and (e): configs/vit_arcface_smoke.yml fitted through
    the Trainer after a softmax pretraining phase, on the dataset its
    comment names, with exact launches; a second Trainer's resume and the
    CLI's resume and export. Returns the launches over the fit."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    root = os.path.join(tmp, "vit")
    t0 = time.perf_counter()
    images = _write_fit_dataset(os.path.join(root, "dataset"),
                                VIT_FIT_CLASSES, VIT_FIT_PER_CLASS,
                                VIT_FIT_SIZE)
    print(f"vit fit: wrote {len(images)} PNGs of {VIT_FIT_CLASSES} classes "
          f"at {VIT_FIT_SIZE} px in {time.perf_counter() - t0:.1f} s")
    path = _fit_config(root, source=VIT_SMOKE_CONFIG, cuts=VIT_FIT_CUTS,
                       settings=VIT_FIT_SETTINGS, label="vit fit")
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    logs = []

    def log(line):
        logs.append(str(line))
        print(f"vit fit: {line}")
    trainer = Trainer(params, loader, device=DEVICE, log_fn=log)
    sp = params.softmax
    # T2 divides the pretraining's val batches (uint8 -> bf16, eval mode);
    # the train steps augment and divide in f32, the recall eval divides
    # in f32, and a ViT has no 3x3 conv
    expected = {name: 0 for name in {**fc.LAUNCHES, **pre.LAUNCHES}}
    expected["normalize_u8"] = sp.n_epochs * sp.val_steps
    print(f"vit fit: predicted launches over the pretraining and the fit: "
          f"{expected}")

    # every train step differentiates each attention core once; the
    # evaluations and recall encodings run the forward alone
    train_steps = (sp.n_epochs * sp.steps_per_epoch
                   + params.train.n_epochs * params.generator.n_batches)

    # ---- the ViT fit's path: every launch count from here to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    cores = _att_reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.pretrain_softmax()
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    history = trainer.fit().history
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0 - pretrain_s
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    _att_read("vit fit", cores,
              bwd=_att_layers(trainer.module) * train_steps)
    # ---- end of the ViT fit's path ----
    peak = torch.cuda.max_memory_allocated()
    # T2 at the one shape this path gives it, the pretraining's val batches
    shape = (sp.batch_size, *params.model.input_shape)
    x = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, 256, shape, np.uint8)).to(DEVICE)
    exact = torch.equal(pre.normalize_u8(x), pre._plain_normalize_u8(x))
    print(f"vit fit: check normalize_u8 B={shape[0]} {list(shape[1:])}: "
          f"tolerance exact (0), equal {exact}")
    if not exact:
        raise AssertionError("vit fit: normalize_u8 differs from its plain "
                             "version at the pretraining's val shape")
    for e, timing in enumerate(trainer.timings):
        print(f"vit fit: epoch {e}: loss {history['loss'][e]:.4f}, "
              f"recall@1 {history['val_recall1'][e]:.4f}, recall@5 "
              f"{history['val_recall5'][e]:.4f}, {timing['epoch_s']:.2f} s "
              f"(train {timing['train_s']:.2f}, waiting "
              f"{timing['data_wait_s']:.2f} for batches, recall "
              f"{timing['recall_s']:.2f}, checkpoint "
              f"{timing['checkpoint_s']:.2f} s, "
              f"{timing['checkpoint_bytes'] / 2 ** 20:.1f} MiB), "
              f"images_per_sec {history['images_per_sec'][e]:.0f} [{smi}]")
    print(f"vit fit: pretraining {pretrain_s:.1f} s, fit {fit_s:.1f} s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches {launches}")
    if not any(HANDOFF_LOG in line for line in logs):
        raise AssertionError("vit fit: the pretraining logged no handoff")
    if not np.all(np.isfinite(history["loss"])):
        raise AssertionError("vit fit: loss not finite")
    for key in ("val_recall1", "val_recall5"):
        if len(history[key]) != 2 or not all(0 <= v <= 1
                                             for v in history[key]):
            raise AssertionError(f"vit fit: {key} {history[key]}")
    if launches != expected:
        raise AssertionError(f"vit fit: launches {launches}, predicted "
                             f"{expected}")
    if trainer.ckpt_mgr.latest_epoch() is None:
        raise AssertionError("vit fit: no checkpoint")
    _resume_check("vit fit", params, loader, trainer)
    del trainer
    _cli_export("vit fit", path, params, images[:64])
    return launches


def vit_phase(smi, tmp):
    """Phase 12: the ViT/ArcFace path; returns the fit's launches."""
    t0 = time.perf_counter()
    vit_step_phase(smi, "vit-b16 step", VIT_CONFIG, VIT_WARMUP, VIT_TIMED)
    vit_step_phase(smi, "clip vit-l14 step", CLIP_CONFIG, CLIP_WARMUP,
                   CLIP_TIMED)
    vit_card_check()
    launches = vit_fit_phase(smi, tmp)
    print(f"vit: phase 12 in {time.perf_counter() - t0:.1f} s")
    return launches


# phase 13: the depthwise family, the simple CNNs and the inference
# remainder. (a) configs/efficientnetb3_batchhard_1024.yml's step at full
# width and depth on colour cells, (b) small models of each new family on
# the card against the CPU, (c) configs/road_signs_tpu.yml fitted on a CSV
# dataset, (d) encode_dataset, the CLIs and the .pt2 on phase 9's export
B3_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG),
                         "efficientnetb3_batchhard_1024.yml")
ROAD_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG), "road_signs_tpu.yml")
TEST_CLI = os.path.join(os.path.dirname(TRAIN_CLI), "test_torch.py")
EVALUATE_CLI = os.path.join(os.path.dirname(TRAIN_CLI), "evaluate_torch.py")
B3_CLASSES, B3_WARMUP, B3_TIMED, B3_PROFILED = 1024, 3, 10, 2
# device time by aten op (self time) and by kernel name: the elementwise
# products, sums and reductions (BatchNorm's eager f32 statistics and
# affine, forward and backward, most of them; also the SE gate's product,
# drop-connect, the augmentation's), SiLU and the SE gate's sigmoid, copies
# (dtype casts); the convs by kernel name, the depthwise ones apart
B3_SHARES = {
    "elementwise_and_reductions": (
        "aten::mean", "aten::square", "aten::pow", "aten::sum", "aten::mul",
        "aten::add", "aten::sub", "aten::rsub", "aten::rsqrt", "aten::lerp_",
        "aten::clamp_min"),
    "silu_sigmoid": ("aten::silu", "aten::silu_backward", "aten::sigmoid",
                     "aten::sigmoid_backward"),
    "copy": ("aten::copy_",),
}
# (b): the families at small size, card against CPU from one state_dict
# and the same drop masks. In float64 on both: the embeddings, the
# triplet loss and every gradient to CARD_TOL of each tensor's largest
# entry, a tensor whose gradient is zero in exact arithmetic (a BatchNorm
# bias before a train-mode BatchNorm) to CARD_TOL of the model's largest
# gradient entry. float32 train-mode BatchNorm on batch statistics
# amplifies two devices' rounding past 1e-5 (on the CPU, two conv layouts
# put MobileNet's f32 embeddings 1.3e-5 apart and simple2's conv_7
# gradient 1.8% apart, a ReLU's kink taking a pre-activation either way),
# so f32 with TF32 off is held in eval mode: the embeddings to CARD_TOL
CARD_FAMILIES = (("efficientnet-b0", 64), ("mobilenet", 64),
                 ("mobilenetv2", 64), ("simple", 72), ("simple2", 64))
CARD_SMALL_B0 = (0.25, 0.5, 224)   # width, depth, resolution
CARD_TOL, CARD_BATCH = 1e-5, 16
# (c): the road-signs config on a CSV index of colour-cell PNGs
ROAD_CLASSES, ROAD_TRAIN, ROAD_VAL, ROAD_SIZE = 40, 8, 2, 48
ROAD_CUTS = [
    ("DATALOADER", "dataset_path", None, "no data on the machine"),
    ("DATALOADER", "train_csv_file", None, "a CSV of the temp dataset"),
    ("DATALOADER", "val_csv_file", None, "a CSV of the temp dataset"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", 8, "run time"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]


def _b3_batches(rng, n, batch, size):
    """``n`` grouped P-K batches (``batch`` / 4 classes x 4) drawn from a
    pool of B3_CLASSES colour-cell classes x 4 images, on the card."""
    pool_classes = np.repeat(np.arange(B3_CLASSES), K_SAMPLES)
    pool = cell_images(rng, pool_classes, size=size)
    out = []
    for _ in range(n):
        picked = rng.choice(B3_CLASSES, batch // K_SAMPLES, replace=False)
        idx = (picked[:, None] * K_SAMPLES
               + np.arange(K_SAMPLES)[None]).reshape(-1)
        out.append((torch.from_numpy(pool[idx]).to(DEVICE),
                    torch.from_numpy(pool_classes[idx]).to(DEVICE)))
    return out


def _depthwise_alone(module, images):
    """The depthwise convs alone, at the step's shapes: each MBConv's
    ``dw_conv`` input captured in an eval forward of ``images`` (bf16
    ``/255``), then every depthwise conv run as its ``F.conv2d`` (padded
    as the module pads it) forward, and backward to its input and weight,
    under torch.profiler. Returns (forward kernel names, backward
    kernel names, forward device ms, backward device ms, the number of
    depthwise convs) of one step's set."""
    from torch.profiler import ProfilerActivity, profile
    from embeddingnet_tpu_torch.models import efficientnet as efn
    captured = []
    hooks = [m.dw_conv.register_forward_hook(
        lambda conv, inp, out: captured.append((conv, inp[0].detach())))
        for m in module.modules() if isinstance(m, efn.MBConv)]
    try:
        with torch.no_grad():
            module.eval()((images.float() / 255.0).to(torch.bfloat16))
    finally:
        for h in hooks:
            h.remove()
    calls = []
    for conv, x in captured:
        # the conv's own padding where symmetric, else F.pad, as
        # SameConv2d runs it (cuDNN picks its kernels by both)
        k, st = conv.kernel_size[0], conv.stride[0]
        (top, bottom), (left, right) = (efn.same_padding(n, k, st)
                                        for n in x.shape[2:])
        padding = (top, left)
        if top != bottom or left != right:
            x, padding = F.pad(x, (left, right, top, bottom)), (0, 0)
        w = conv.weight.detach().bfloat16().requires_grad_()
        calls.append((x.requires_grad_(), w, st, padding, conv.groups))

    def kernels(prof):
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        return {e.name for e in ev}, sum(e.device_time_total for e in ev)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as fwd:
        outs = [F.conv2d(x, w, None, st, pad, 1, g)
                for x, w, st, pad, g in calls]
        torch.cuda.synchronize()
    grads = [torch.ones_like(o) for o in outs]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as bwd:
        torch.autograd.backward(outs, grads)
        torch.cuda.synchronize()
    (f_names, f_us), (b_names, b_us) = kernels(fwd), kernels(bwd)
    module.train()
    return f_names, b_names - f_names, f_us * 1e-3, b_us * 1e-3, len(calls)


def _b3_profile(state, step, batches, depthwise_names):
    """torch.profiler over ``batches``: device ms a step, busy share, the
    B3_SHARES and the convs' device time by kernel name (the depthwise
    forward and backward kernels, ``depthwise_names``, apart from the
    other convs), the top kernels."""
    prof, kernels, wall = _profile_agreed(
        _run_steps(state, step, batches), "b3 step")
    n = len(batches)
    busy_us = sum(e.device_time_total for e in kernels)
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total
    convs = {"depthwise_fwd": 0.0, "depthwise_bwd": 0.0, "other_conv": 0.0}
    fwd_names, bwd_names = depthwise_names
    for name, us in by_kernel.items():
        if name in fwd_names:
            convs["depthwise_fwd"] += us
        elif name in bwd_names:
            convs["depthwise_bwd"] += us
        elif any(t in name.lower() for t in ("conv", "fprop", "dgrad",
                                             "wgrad", "implicit", "xmma",
                                             "gemm")):
            convs["other_conv"] += us
    by_op = {e.key: e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.self_device_time_total > 0}
    return {"device_ms": busy_us * 1e-3 / n, "busy": busy_us * 1e-6 / wall,
            "n": n, "convs_ms": {k: v * 1e-3 / n for k, v in convs.items()},
            "shares": {name: sum(by_op.get(k, 0.0) for k in ops) / busy_us
                       for name, ops in B3_SHARES.items()},
            "top_kernels": sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1])[:12],
            "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:12]}


def b3_step_phase(smi):
    """Phase 13 (a): the B3 config's triplet step at full width and depth
    through make_triplet_train_step, as the Trainer builds it (batch_hard,
    the default augmentation, bf16, bn_momentum 0.9, Adam with its warm-up
    schedule, drop-connect drawn from the state's generator): warm-up,
    timed steps with every port kernel's launches counted (all 0: the
    family has no kernel of the port, and the augmented step divides in
    f32), median, images/s, peak memory; profiled steps; the miner alone;
    one semihard step (the config's warm-up mode)."""
    from embeddingnet_tpu_torch.config import parse_params
    params = parse_params(B3_CONFIG)
    m, g, t, perf = (params.model, params.generator, params.train,
                     params.performance)
    batch = g.k_classes * g.k_samples
    shape = tuple(m.input_shape)
    print(f"b3 step: set from {os.path.relpath(B3_CONFIG)}: "
          f"{m.backbone_name}, input {list(shape)}, {m.encodings_len}-d, "
          f"B={batch} as P-K {g.k_classes}x{g.k_samples}, "
          f"{g.negatives_selection_mode} (warm-up {t.mining_warmup_epochs} "
          f"epochs {t.mining_warmup_mode}), margin {g.margin}, "
          f"{t.optimizer} {t.learning_rate} (warm-up {t.warmup_epochs} epoch "
          f"of {g.n_batches} steps, decay {t.decay_factor}), augmentation "
          f"{g.augmentations!r}, {perf.compute_dtype}, bn_momentum "
          f"{perf.bn_momentum}, drop-connect 0.2")
    print(f"b3 step: reduced DATALOADER.dataset_path: {B3_CLASSES} classes "
          f"of synthetic colour cells (no data on the machine)")
    t0 = time.perf_counter()
    dtype = torch.bfloat16
    module = EmbeddingModule(m.backbone_name, encodings_len=m.encodings_len,
                             bn_momentum=perf.bn_momentum, dtype=dtype,
                             input_shape=shape).to(DEVICE)
    module.reset_parameters(torch.Generator(DEVICE).manual_seed(SEED))
    spec = get_optimizer(t.optimizer, step_decay_schedule(
        t.learning_rate, t.decay_factor, t.step_size, g.n_batches,
        warmup_epochs=t.warmup_epochs))
    state = TrainState.create(module, spec, generator=torch.Generator(
        DEVICE).manual_seed(SEED + 1))
    kw = dict(margin=g.margin, augment_fn=aug.get_aug(g.augmentations),
              compute_dtype=dtype, max_positives=g.k_samples - 1)
    step = make_triplet_train_step(module, spec,
                                   mode=g.negatives_selection_mode, **kw)
    batches = _b3_batches(np.random.default_rng(SEED + 14),
                          B3_WARMUP + B3_TIMED + B3_PROFILED + 1, batch,
                          shape[0])
    _timed_steps(state, step, batches[:B3_WARMUP])
    n_params = sum(p.numel() for p in module.parameters())
    print(f"b3 step: {n_params / 1e6:.2f} M parameters, head "
          f"{module.backbone.out_channels} channels; built and {B3_WARMUP} "
          f"warm-up steps in {time.perf_counter() - t0:.1f} s")
    # ---- the B3 step's path: every launch count from here to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    timed = batches[B3_WARMUP:B3_WARMUP + B3_TIMED]
    times, metrics = _timed_steps(state, step, timed)
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the B3 step's path ----
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    losses = [x["loss"] for x in metrics]
    print(f"b3 step: {B3_TIMED} steps of B={batch}: median "
          f"{med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {batch / med:.0f} img/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{smi}]")
    print(f"b3 step: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; port kernel launches over the timed steps: {launches}")
    if not np.all(np.isfinite(losses)) or any(launches.values()):
        raise AssertionError(f"b3 step: losses {losses}, launches "
                             f"{launches}")
    images, labels = batches[0]
    f_names, b_names, f_ms, b_ms, n_dw = _depthwise_alone(module, images)
    print(f"b3 step: the {n_dw} depthwise convs alone at the step's shapes "
          f"(F.conv2d, bf16 channels_last): forward {f_ms:.2f} ms, backward "
          f"(input and weight) {b_ms:.2f} ms of device time; kernels: "
          f"forward {sorted(n[:60] for n in f_names)}, backward "
          f"{sorted(n[:60] for n in b_names)}")
    prof = _b3_profile(state, step, batches[B3_WARMUP + B3_TIMED:-1],
                       (f_names, b_names))
    conv = prof["convs_ms"]
    print(f"b3 step: torch.profiler over {prof['n']} steps: "
          f"{prof['device_ms']:.2f} ms of device time per step, busy "
          f"{prof['busy']:.3f} of the profiled wall, "
          f"{prof['device_ms'] / (med * 1e3):.3f} of the unprofiled median; "
          f"by kernel name: depthwise forward {conv['depthwise_fwd']:.2f} "
          f"ms, depthwise backward {conv['depthwise_bwd']:.2f} ms, the "
          f"other convs {conv['other_conv']:.2f} ms (a depthwise kernel "
          f"name that the others share counts as depthwise); by aten op: "
          + ", ".join(f"{k} {v:.3f}" for k, v in prof["shares"].items())
          + " of the device time")
    for name, us in prof["top_ops"]:
        print(f"  profile top op: {us / prof['n'] / 1e3:8.3f} ms/step  "
              f"{name}")
    for name, us in prof["top_kernels"]:
        print(f"  profile top kernel: {us / prof['n'] / 1e3:8.3f} ms/step  "
              f"{name[:100]}")
    miner_ms = _mining_device_ms(module, state, images, labels,
                                 g.negatives_selection_mode, g.k_samples - 1)
    print(f"b3 step: the miner alone ({g.negatives_selection_mode}, forward "
          f"and backward): {miner_ms:.3f} ms of device time")
    warm = make_triplet_train_step(module, spec, mode=t.mining_warmup_mode,
                                   **kw)
    (semi_s,), (semi,) = _timed_steps(state, warm, batches[-1:])
    print(f"b3 step: one {t.mining_warmup_mode} step (the warm-up mode): "
          f"{semi_s * 1e3:.2f} ms, loss {semi['loss']:.4f}, n_triplets "
          f"{semi['n_triplets']:.0f}")
    if not np.isfinite(semi["loss"]):
        raise AssertionError("b3 step: the semihard loss is not finite")
    del module, state, step, warm, batches
    torch.cuda.empty_cache()


def _zero_in_exact_arithmetic(grads):
    """Names of the gradients below 1e-8 of the model's largest entry."""
    top = max(g.abs().max().item() for g in grads.values())
    return {n for n, g in grads.items() if g.abs().max().item() < 1e-8 * top}


def depthwise_card_check():
    """Phase 13 (b): each new family, small, on the card against the CPU
    from one state_dict (see CARD_FAMILIES): float64 train mode with the
    masks the CPU run drew fed to the card, then float32 eval mode."""
    import copy
    from embeddingnet_tpu_torch.models import efficientnet as efn
    from embeddingnet_tpu_torch.models.stochastic import MaskSource
    from embeddingnet_tpu_torch.ops.mining import mined_triplet_loss
    rng = np.random.default_rng(SEED + 15)
    labels = torch.arange(CARD_BATCH // 4).repeat_interleave(4)
    saved = efn.SCALINGS["efficientnet-b0"]
    efn.SCALINGS["efficientnet-b0"] = CARD_SMALL_B0
    try:
        for name, size in CARD_FAMILIES:
            cpu = EmbeddingModule(name, encodings_len=64, classifier=False,
                                  input_shape=(size, size, 3))
            cpu.reset_parameters(torch.Generator().manual_seed(SEED))
            images = torch.from_numpy(rng.uniform(
                0, 1, (CARD_BATCH, size, size, 3)))
            out, masks = {}, None
            for where in ("cpu", "card"):
                module = copy.deepcopy(cpu).double().train()
                device = "cpu" if where == "cpu" else DEVICE
                module.to(device)
                source = (MaskSource(generator=torch.Generator()
                                     .manual_seed(SEED)) if masks is None
                          else MaskSource(masks))
                emb = module(images.to(device), source)
                masks = source.drawn
                loss, _ = mined_triplet_loss(emb, labels.to(device),
                                             margin=MARGIN,
                                             mode="batch_hard")
                loss.backward()
                out[where] = (emb.detach().cpu(), loss.item(), {
                    n: p.grad.cpu() for n, p in module.named_parameters()})
            (e_cpu, l_cpu, g_cpu), (e_card, l_card, g_card) = (
                out["cpu"], out["card"])
            zero = _zero_in_exact_arithmetic(g_cpu)
            top = max(g.abs().max().item() for g in g_cpu.values())
            worst = {"embeddings": ((e_card - e_cpu).abs().max()
                                    / e_cpu.abs().max()).item(),
                     "loss": abs(l_card - l_cpu) / abs(l_cpu)}
            for n, grad in g_cpu.items():
                scale = top if n in zero else grad.abs().max().item()
                worst[n] = (g_card[n] - grad).abs().max().item() / scale
            cpu32 = copy.deepcopy(cpu).eval()
            card32 = copy.deepcopy(cpu).to(DEVICE).eval()
            with torch.no_grad():
                e32 = cpu32(images.float())
                worst["f32 eval embeddings"] = ((
                    card32(images.float().to(DEVICE)).cpu() - e32).abs()
                    .max() / e32.abs().max()).item()
            key = max(worst, key=worst.get)
            print(f"card check {name} at {size} px, B={CARD_BATCH} "
                  f"({len(masks)} masks, {len(zero)} gradients zero in "
                  f"exact arithmetic): float64 embeddings "
                  f"{worst['embeddings']:.2e}, loss {l_card:.6f} against "
                  f"{l_cpu:.6f} ({worst['loss']:.2e}); f32 eval embeddings "
                  f"{worst['f32 eval embeddings']:.2e}; worst of "
                  f"{len(g_cpu)} gradients and the rest: {key} "
                  f"{worst[key]:.2e}; tolerance {CARD_TOL:g}")
            if not all(np.isfinite(list(worst.values()))) or \
                    worst[key] > CARD_TOL:
                raise AssertionError(f"card check {name}: {key} off by "
                                     f"{worst[key]:.2e}")
    finally:
        efn.SCALINGS["efficientnet-b0"] = saved


def _write_csv_dataset(root):
    """The road-signs layout: ROAD_CLASSES classes of colour-cell PNGs at
    ROAD_SIZE px, listed in ``train.csv`` and ``val.csv`` under the
    config's ``file_path``/``class_name`` columns; returns the images."""
    import cv2
    per = ROAD_TRAIN + ROAD_VAL
    classes = np.repeat(np.arange(ROAD_CLASSES), per)
    images = cell_images(np.random.default_rng(SEED + 16), classes,
                         size=ROAD_SIZE)
    rows = {"train": [], "val": []}
    for i, c in enumerate(classes):
        rel = os.path.join(f"sign_{c:03d}", f"{i % per}.png")
        os.makedirs(os.path.join(root, f"sign_{c:03d}"), exist_ok=True)
        if not cv2.imwrite(os.path.join(root, rel), images[i]):
            raise OSError(f"cv2 could not write {rel}")
        rows["train" if i % per < ROAD_TRAIN else "val"].append(
            f"{rel},sign_{c:03d}")
    for split, lines in rows.items():
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("file_path,class_name\n" + "\n".join(lines) + "\n")
    return images


def road_signs_phase(smi, tmp):
    """Phase 13 (c): configs/road_signs_tpu.yml fitted through the Trainer
    on a CSV dataset (cut as ROAD_CUTS prints): loss per epoch, T2's
    launches exact (the val epochs' uint8 -> bf16), every other kernel at
    0, T2 against its plain version at the val batches' shape, and a second
    Trainer's resume bit for bit. Returns the fit's launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    root = os.path.join(tmp, "road")
    data = os.path.join(root, "dataset")
    t0 = time.perf_counter()
    images = _write_csv_dataset(data)
    print(f"road signs: wrote {len(images)} PNGs of {ROAD_CLASSES} classes "
          f"at {ROAD_SIZE} px and train.csv/val.csv in "
          f"{time.perf_counter() - t0:.1f} s")
    path = _fit_config(root, source=ROAD_CONFIG, cuts=ROAD_CUTS,
                       label="road signs", values={
                           "train_csv_file": os.path.join(data, "train.csv"),
                           "val_csv_file": os.path.join(data, "val.csv")})
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device=DEVICE,
                      log_fn=lambda line: print(f"road signs: {line}"))
    g, t = params.generator, params.train
    expected = {name: 0 for name in {**fc.LAUNCHES, **pre.LAUNCHES}}
    # the augmented train steps divide in f32; each val batch's eval
    # forward of 3 x batch_size divides by T2 (uint8 -> bf16)
    expected["normalize_u8"] = t.n_epochs * g.n_batches_val
    print(f"road signs: {params.model.backbone_name} at "
          f"{list(params.model.input_shape)}, B={g.k_classes * g.k_samples} "
          f"as P-K {g.k_classes}x{g.k_samples} (GENERATOR.batch_size "
          f"{g.batch_size} sizes the val triplets), "
          f"{g.negatives_selection_mode}, {t.optimizer}, "
          f"{params.performance.compute_dtype}; {loader.n_classes} classes; "
          f"predicted launches {expected}")
    # ---- the road-signs fit's path: every launch count to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.fit().history
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the road-signs fit's path ----
    for e, timing in enumerate(trainer.timings):
        print(f"road signs: epoch {e}: loss {history['loss'][e]:.4f}, "
              f"val_loss {history['val_loss'][e]:.4f}, "
              f"{timing['epoch_s']:.2f} s (train {timing['train_s']:.2f}, "
              f"waiting {timing['data_wait_s']:.2f} for batches, val "
              f"{timing['val_s']:.2f}, checkpoint "
              f"{timing['checkpoint_s']:.2f} s), images_per_sec "
              f"{history['images_per_sec'][e]:.0f} [{smi}]")
    print(f"road signs: fit {fit_s:.1f} s; launches {launches}")
    x = torch.from_numpy(np.random.default_rng(SEED + 17).integers(
        0, 256, (3 * g.batch_size, *params.model.input_shape),
        np.uint8)).to(DEVICE)
    exact = torch.equal(pre.normalize_u8(x), pre._plain_normalize_u8(x))
    print(f"road signs: check normalize_u8 B={x.shape[0]} "
          f"{list(x.shape[1:])}: tolerance exact (0), equal {exact}")
    if not exact:
        raise AssertionError("road signs: normalize_u8 differs from its "
                             "plain version at the val batches' shape")
    for key in ("loss", "val_loss"):
        if not np.all(np.isfinite(history[key])):
            raise AssertionError(f"road signs: {key} {history[key]}")
    if launches != expected:
        raise AssertionError(f"road signs: launches {launches}, predicted "
                             f"{expected}")
    _resume_check("road signs", params, loader, trainer)
    return launches


def inference_phase(smi, tmp):
    """Phase 13 (d): on phase 9's CLI export (the flagship ResNet-50,
    pallas_conv on, bf16): encode_dataset over its 10,240 PNGs, the
    evaluate CLI against calculate_prediction_accuracy, the test CLI
    against predict_knn, the .pt2 reloaded on the card against the
    module, with K3's launches predicted exactly; K3 against its plain
    version at the test CLI's B=1. Returns the launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    path = os.path.join(tmp, "config.yml")
    params = parse_params(path)
    work = os.path.join(params.general.work_dir,
                        params.general.project_name)
    weights = os.path.join(work, "base_model.pt")
    encodings = os.path.join(work, "encodings", "encodings.pkl")
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    paths = loader.flat("train")[0] + loader.flat("val")[0]
    n_val = len(loader.flat("val")[0])
    t0 = time.perf_counter()
    net = EmbeddingNet.for_inference(params, weights, encodings,
                                     device=DEVICE)
    print(f"inference: {params.model.backbone_name}, pallas_conv "
          f"{params.performance.pallas_conv}, "
          f"{params.performance.compute_dtype}, loaded in "
          f"{time.perf_counter() - t0:.1f} s; {len(paths)} PNGs, {n_val} "
          f"val, DB {len(net.encoded_training_data['labels'])}")
    k3 = "conv3x3_small_bn_relu"
    per_forward = sum(n for _, _, n in FUSED_SHAPES)
    forwards = (-(-len(paths) // DB_BATCH) + -(-n_val // DB_BATCH)
                + 1 + 1)
    expected = {name: 0 for name in {**fc.LAUNCHES, **pre.LAUNCHES}}
    expected[k3] = per_forward * forwards
    print(f"inference: predicted launches {expected} ({forwards} forwards: "
          f"encode_dataset in {DB_BATCH}s, the evaluate CLI's val batches, "
          f"the test CLI's image, the module against the .pt2)")
    image = loader.flat("val")[0][0]
    # ---- the inference path: every launch count from here to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = net.encode_dataset(paths, batch_size=DB_BATCH)
    encode_s = time.perf_counter() - t0
    acc = runpy.run_path(EVALUATE_CLI)["main"](
        [path, "--weights", weights, "--encodings", encodings,
         "--device", DEVICE])
    label = runpy.run_path(TEST_CLI)["main"](
        [path, "--weights", weights, "--encodings", encodings, "--image",
         image, "--device", DEVICE])
    t1 = time.perf_counter()
    exported = net.save_exported(os.path.join(tmp, "export"))
    export_s = time.perf_counter() - t1
    x = torch.from_numpy(np.random.default_rng(SEED + 18).uniform(
        0, 1, (1, *params.model.input_shape)).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        want = net.module(x).float()
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the inference path ----
    CV2_NUMBERS["encode"] = {"img_s": len(paths) / encode_s,
                             "n": len(paths)}
    print(f"inference: encode_dataset of {len(paths)} PNGs in "
          f"{encode_s:.2f} s, {len(paths) / encode_s:.0f} img/s (cv2 decode "
          f"on 8 threads included), shape {list(emb.shape)} [{smi}]; "
          f"launches {launches}")
    if emb.shape != (len(paths), params.model.encodings_len) or \
            not np.isfinite(emb).all():
        raise AssertionError(f"inference: encode_dataset {emb.shape}")
    if launches != expected:
        raise AssertionError(f"inference: launches {launches}, predicted "
                             f"{expected}")
    direct_acc = net.calculate_prediction_accuracy(loader)
    direct_label = net.predict_knn(image)
    print(f"inference: the evaluate CLI {acc}, direct {direct_acc}; the "
          f"test CLI {label!r}, predict_knn {direct_label!r}")
    if acc != direct_acc or label != direct_label:
        raise AssertionError("inference: a CLI differs from the direct "
                             "call")
    program = torch.export.load(exported).module()
    with torch.inference_mode():
        got = program(x)
    print(f"inference: the .pt2 ({os.path.getsize(exported) / 2 ** 20:.1f} "
          f"MiB, exported in {export_s:.1f} s, traced on the library path) "
          f"reloaded on the card")
    _check("inference: .pt2 against the module", got, want, ATOL, RTOL)
    rng = np.random.default_rng(SEED + 19)
    for s, c, _ in FUSED_SHAPES:
        xk = _tensor(rng, (1, s, s, c)).bfloat16()
        wk = _tensor(rng, (3, 3, c, c), 0.05).bfloat16()
        scale, bias = _affine(rng, c)
        _check(f"inference: {k3} B=1 S={s} C={c}",
               fc.conv3x3_small_bn_relu(xk, wk, scale, bias),
               fc._plain_conv3x3(fc._affine_relu(xk, scale, bias).float(),
                                 wk.float()), ATOL, RTOL)
    return launches


def depthwise_phase(smi, tmp):
    """Phase 13; returns the launches of (c) and (d)."""
    t0 = time.perf_counter()
    b3_step_phase(smi)
    depthwise_card_check()
    road = road_signs_phase(smi, tmp)
    inference = inference_phase(smi, tmp)
    print(f"depthwise: phase 13 in {time.perf_counter() - t0:.1f} s")
    return road, inference


# -- phase 14: data-parallel training, remat, bf16 master weights ------------

SHARDED_CONFIG = os.path.join(os.path.dirname(FIT_CONFIG),
                              "batch4096_sharded.yml")
DP_WARMUP, DP_TIMED, DP_PROFILED = 3, 10, 2
DP_POOL_PER_CLASS = 8
# (b): the flagship step, remat on against off, from the same state and
# batch: float64 (every op, the miner in f32 as the step casts) to 1e-12 of
# each tensor's largest entry, at B = REMAT_F64_BATCH; bf16 with the
# kernels at the flagship batch bit for bit (the same kernels on the same
# inputs, cuDNN held to its deterministic algorithms)
REMAT_F64_BATCH, REMAT_F64_TOL = 64, 1e-12
# the flagship step's launches under remat: the fused op's forward runs
# again in the backward (K3 twice); the backward kernels once
REMAT_PER_STEP = {**EXPECTED_PER_STEP, "conv3x3_small_bn_relu":
                  2 * EXPECTED_PER_STEP["conv3x3_small_bn_relu"]}
# (c): the config fitted through torchrun and the CLI, with these cuts
DP_FIT_CUTS = [
    ("DATALOADER", "dataset_path", None, "no data on the machine"),
    ("GENERATOR", "n_batches", 4, "run time"),
    ("GENERATOR", "n_batches_val", 1, "run time"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("TRAIN", "eval_recall_every", 1, "so the recall runs through the "
                                      "sharded kNN every epoch"),
    ("ENCODINGS", "save_encodings", False, "run time: phases 9 and 13 "
                                            "export encodings"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]
DP_FIT_SETTINGS = [("PERFORMANCE", "async_checkpoint", True)]
CHILD_FLAG = "--fit-child"


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world1_nccl():
    """An NCCL process group of one rank on this card, through a free
    local port."""
    import torch.distributed as dist
    from embeddingnet_tpu_torch.parallel.collectives import DataParallel
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device(DEVICE, 0))
    return DataParallel.current()


def _dp_module(params, fast_conv=False, dtype=torch.bfloat16):
    """The config's encoder (ResNet-50), random weights from SEED."""
    m = params.model
    module = EmbeddingModule(
        backbone_name=m.backbone_name, encodings_len=m.encodings_len,
        embeddings_normalization=m.embeddings_normalization,
        bn_momentum=params.performance.bn_momentum, fast_conv=fast_conv,
        dtype=dtype)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    return module.to(DEVICE)


def _dp_step(params, dp, remat, dtype=torch.bfloat16):
    """The config's triplet step (its optimizer, schedule and preset) on a
    fresh :func:`_dp_module`: ``(module, state, step)``."""
    from embeddingnet_tpu_torch.ops.augment import get_aug
    t, g = params.train, params.generator
    module = _dp_module(params, dtype=dtype)
    spec = get_optimizer(t.optimizer, step_decay_schedule(
        t.learning_rate, t.decay_factor, t.step_size, g.n_batches,
        warmup_epochs=t.warmup_epochs))
    state = TrainState.create(module, spec, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED + 1))
    step = make_triplet_train_step(
        module, spec, margin=g.margin, mode=g.negatives_selection_mode,
        augment_fn=get_aug(g.augmentations), compute_dtype=dtype,
        max_positives=g.k_samples - 1, remat=remat, parallel=dp)
    return module, state, step


def _profile_steps(state, step, batches):
    """(device ms per step, {kernel name: device us}, {collective: host us})
    over the steps, from a read that a second read agreed with; the
    collectives are the CPU-side ``nccl:*`` ranges that c10d records around
    each NCCL call."""
    prof, kernels, _ = _profile_agreed(_run_steps(state, step, batches),
                                       "the sharded step's profile")
    by_name, host = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("nccl:")):
            host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total
    return sum(by_name.values()) * 1e-3 / len(batches), by_name, host


def _sharded_mining_device_ms(dp, module, state, images, labels,
                              max_positives):
    """Device time of the step's miner alone (the row-sharded batch-all,
    forward and backward) on the embeddings of ``images``."""
    from embeddingnet_tpu_torch.parallel.sharded import \
        sharded_batch_all_loss
    from embeddingnet_tpu_torch.train.steps import make_eval_step
    emb = make_eval_step(module, compute_dtype=torch.bfloat16)(state, images)
    fn = sharded_batch_all_loss(dp, margin=MARGIN,
                                max_positives=max_positives)

    def run():
        e = emb.detach().requires_grad_()
        loss, _ = fn(e, labels)
        loss.backward()
    return device_ms(run)


def sharded_step_phase(smi, params):
    """(a) The config's step at full width and global batch on this card:
    the data-parallel path at world 1 (an NCCL group; the collectives run),
    remat on (as the config says) and off. Returns the launches over the
    timed steps (the config sets pallas_conv off: none of the convs')."""
    import torch.distributed as dist
    g = params.generator
    batch = g.k_classes * g.k_samples
    classes = np.repeat(np.arange(g.k_classes), DP_POOL_PER_CLASS)
    pool = cell_images(np.random.default_rng(SEED + 14), classes)
    host = _pk_batches(pool, classes, DP_WARMUP + DP_TIMED + DP_PROFILED,
                       seed=SEED + 14, k_classes=g.k_classes)
    batches = [(x.to(DEVICE), y.to(DEVICE)) for x, y in host]
    del pool, host
    dp = _world1_nccl()
    rows, launches = {}, None
    try:
        for remat in (True, False):
            label = f"sharded step (remat {'on' if remat else 'off'})"
            module, state, step = _dp_step(params, dp, remat)
            _, warm = _timed_steps(state, step, batches[:DP_WARMUP])
            torch.cuda.reset_peak_memory_stats()
            fc.reset_launch_counts()
            pre.reset_launch_counts()
            times, metrics = _timed_steps(
                state, step, batches[DP_WARMUP:DP_WARMUP + DP_TIMED])
            counted = {**fc.LAUNCHES, **pre.LAUNCHES}
            peak = torch.cuda.max_memory_allocated()
            launches = launches or counted
            dev_ms, by_name, host = _profile_steps(state, step,
                                                   batches[-DP_PROFILED:])
            nccl = [name for name in by_name if "nccl" in name.lower()]
            nccl_us = sum(by_name[name] for name in nccl)
            host_us = sum(host.values())
            images, labels = batches[0]
            miner_ms = _sharded_mining_device_ms(
                dp, module, state, images, labels, g.k_samples - 1)
            median = float(np.median(times))
            losses = [m["loss"] for m in warm + metrics]
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"{label}: a loss is not finite: "
                                     f"{losses}")
            if not all(m["n_triplets"] > 0 for m in metrics):
                raise AssertionError(f"{label}: a step mined no triplet")
            rows[remat] = {"median_ms": median * 1e3,
                           "images_per_s": batch / median,
                           "device_ms": dev_ms,
                           "busy_share": dev_ms * 1e-3 / median,
                           "peak_gib": peak / 2 ** 30,
                           "miner_device_ms": miner_ms,
                           "collectives_device_ms":
                               nccl_us * 1e-3 / DP_PROFILED,
                           "collectives_host_ms":
                               host_us * 1e-3 / DP_PROFILED}
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            print(f"{label}: B={batch} ({g.k_classes} x {g.k_samples}), "
                  f"ResNet-50 64x64, bf16, batch_all, the default preset: "
                  f"median step {median * 1e3:.2f} ms over {DP_TIMED} "
                  f"(after {DP_WARMUP} warm-up), {batch / median:.0f} "
                  f"img/s, device {dev_ms:.2f} ms a step (busy "
                  f"{dev_ms * 1e-3 / median:.3f} of the median), peak "
                  f"{peak / 2 ** 30:.2f} GiB, the sharded miner alone "
                  f"{miner_ms:.3f} ms of device time (fwd+bwd), the "
                  f"collectives: {len(nccl)} NCCL kernel name(s), "
                  f"{nccl_us * 1e-3 / DP_PROFILED:.3f} ms of device time "
                  f"and {host_us * 1e-3 / DP_PROFILED:.3f} ms of host time "
                  f"in {sum(1 for _ in host)} kind(s) of nccl:* call a step "
                  f"({', '.join(sorted(host))}); losses "
                  + " ".join(f"{l:.4f}" for l in losses) + f" [{smi}]")
            print(f"{label}: top kernels " + "; ".join(
                f"{name[:60]} {us * 1e-3 / DP_PROFILED:.2f} ms"
                for name, us in top))
            del module, state, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if not rows[True]["peak_gib"] < rows[False]["peak_gib"]:
        raise AssertionError(f"remat did not lower the peak: "
                             f"{rows[True]['peak_gib']:.2f} GiB against "
                             f"{rows[False]['peak_gib']:.2f}")
    for name, n in launches.items():
        if n:
            raise AssertionError(f"sharded step: {name} launched {n} times "
                                 f"with pallas_conv off")
    print(f"sharded step: remat lowers the peak {rows[False]['peak_gib']:.2f}"
          f" -> {rows[True]['peak_gib']:.2f} GiB and costs "
          f"{rows[True]['median_ms'] / rows[False]['median_ms'] - 1:+.3f} "
          f"of the step")
    return launches, rows


def remat_check_phase(smi, params):
    """(b) Remat on the flagship step with the kernels (``pallas_conv``
    on): remat on against off from the same state and batch, in float64
    (every op) and in bf16 (K1-K4 under the recompute, their launches
    counted). Returns the remat step's launches."""
    pool_classes = np.repeat(np.arange(P_CLASSES), 8)
    pool = cell_images(np.random.default_rng(SEED + 15), pool_classes)
    f64_batch = _pk_batches(pool, pool_classes, 1, seed=SEED + 15,
                            k_classes=REMAT_F64_BATCH // K_SAMPLES)[0]
    bf16_batch = _pk_batches(pool, pool_classes, 1, seed=SEED + 16)[0]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches = _remat_pairs(smi, params, f64_batch, bf16_batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return launches


def _remat_pairs(smi, params, f64_batch, bf16_batch):
    """The remat-on and remat-off steps of :func:`remat_check_phase`,
    compared; returns the bf16 remat step's launches."""
    import copy
    launches = None
    for dtype, batch in ((torch.float64, f64_batch),
                         (torch.bfloat16, bf16_batch)):
        label = f"remat check ({str(dtype)[6:]}, B={len(batch[1])})"
        base = _dp_module(params, fast_conv=True,
                          dtype=None if dtype == torch.float64 else dtype)
        if dtype == torch.float64:
            base.double()
        out = {}
        for remat in (False, True):
            module = copy.deepcopy(base)
            spec = get_optimizer("sgd", 0.05)
            state = TrainState.create(module, spec)
            step = make_triplet_train_step(
                module, spec, margin=MARGIN, mode="batch_all",
                compute_dtype=dtype, max_positives=K_SAMPLES - 1,
                remat=remat)
            fc.reset_launch_counts()
            pre.reset_launch_counts()
            _, m = step(state, *batch)
            torch.cuda.synchronize()
            counted = {**fc.LAUNCHES, **pre.LAUNCHES}
            out[remat] = (m["loss"].double(),
                          {n: p.grad.double() for n, p in
                           module.named_parameters()},
                          {k: v.double() for k, v in
                           module.state_dict().items()}, counted)
        (l0, g0, s0, c0), (l1, g1, s1, c1) = out[False], out[True]
        if dtype == torch.float64:
            worst = max([float((g1[k] - v).abs().max()
                               / v.abs().max().clamp_min(1e-300))
                         for k, v in g0.items()]
                        + [float((s1[k] - v).abs().max()
                                 / v.abs().max().clamp_min(1e-300))
                           for k, v in s0.items() if v.numel()])
            dl = float((l1 - l0).abs() / l0.abs())
            print(f"{label}: remat on against off: loss {float(l1):.12f} "
                  f"vs {float(l0):.12f}, worst gradient, parameter or "
                  f"running statistic {worst:.3e} of its largest entry "
                  f"(bound {REMAT_F64_TOL})")
            if worst > REMAT_F64_TOL or dl > REMAT_F64_TOL:
                raise AssertionError(f"{label}: remat changes the step")
        else:
            differ = [k for k, v in g0.items() if not torch.equal(g1[k], v)]
            differ += [k for k, v in s0.items() if not torch.equal(s1[k], v)]
            print(f"{label}: remat on against off: loss {float(l1):.6f} vs "
                  f"{float(l0):.6f}, {len(differ)} of {len(g0) + len(s0)} "
                  f"gradients, parameters and running statistics differ "
                  f"(bound: bit-equal); launches off {c0}, on {c1} [{smi}]")
            if not torch.equal(l1, l0) or differ:
                raise AssertionError(f"{label}: remat changes the step: "
                                     f"{differ[:8]}")
            _check_launches(label + " off", c0, EXPECTED_PER_STEP, 1)
            _check_launches(label + " on", c1, REMAT_PER_STEP, 1)
            launches = c1
        del base
        torch.cuda.empty_cache()
    return launches


def _fit_child(argv):
    """``torchrun --nproc_per_node=N chip_smoke.py --fit-child CFG OUT
    [CLI flags]``: the train CLI's ``main`` on this rank (its process group
    from torchrun's environment), the T2 launches over it, the final live
    state's digest (taken as the CLI calls ``restore_best``), the history,
    and the recall of the restored best epoch by the plain kNN, written to
    OUT as JSON by rank 0."""
    from embeddingnet_tpu_torch.parallel.collectives import state_digest
    from embeddingnet_tpu_torch.train.loop import Trainer
    cfg, out, flags = argv[0], argv[1], argv[2:]
    # cuDNN's deterministic algorithms: a resumed run must match bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    digest = {}
    restore_best = Trainer.restore_best

    def wrapped(self):
        digest["final"] = state_digest(self.module).tolist()
        return restore_best(self)
    Trainer.restore_best = wrapped
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    trainer, _ = runpy.run_path(TRAIN_CLI)["main"]([cfg, *flags])
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    trainer.parallel = None         # the plain kNN on the restored best
    plain = trainer.evaluate_recall()
    if int(os.environ.get("RANK", "0")) == 0:
        with open(out, "w") as f:
            json.dump({"launches": launches, "digest": digest["final"],
                       "history": trainer.history.history,
                       "plain_recall": plain,
                       "monitor": trainer.ckpt_mgr.monitor}, f)


def _torchrun(cfg, out, *flags, nproc=1):
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", "--master_port", str(_free_port()),
           os.path.abspath(__file__), CHILD_FLAG, cfg, out, *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    took = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("epoch ") or "resumed" in line:
            print(f"  [torchrun] {line[:240]}")
    if proc.returncode:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise AssertionError(f"torchrun {' '.join(flags)} exited "
                             f"{proc.returncode}")
    with open(out) as f:
        return json.load(f), took


def sharded_fit_phase(smi, tmp):
    """(c) The config fitted through ``torchrun --nproc_per_node=1`` and
    the train CLI, cut (``reduced`` lines), on phase 9's 10,240 PNGs:
    T2's launches (2 x the val batches), the recall through the sharded
    kNN equal to the plain kNN's on the restored best epoch, and a second
    torchrun run resumed from epoch 0's checkpoint ending bit for bit where
    the straight run ended. Returns the straight run's launches."""
    import shutil
    path = _fit_config(tmp, source=SHARDED_CONFIG, cuts=DP_FIT_CUTS,
                       settings=DP_FIT_SETTINGS, label="sharded fit",
                       work="sharded_work", name="sharded.yml")
    straight, took = _torchrun(path, os.path.join(tmp, "straight.json"))
    h = straight["history"]
    print(f"sharded fit: torchrun --nproc_per_node=1, {len(h['loss'])} "
          f"epochs in {took:.1f} s (process start and decode included); "
          + "; ".join(f"{k} " + " ".join(f"{v:.4f}" for v in vals)
                      for k, vals in h.items()) + f" [{smi}]")
    for key in ("loss", "val_loss"):
        if not np.all(np.isfinite(h[key])):
            raise AssertionError(f"sharded fit: {key} not finite")
    launches = straight["launches"]
    from embeddingnet_tpu_torch.config import parse_params
    cut = parse_params(path)
    val_batches = cut.generator.n_batches_val * cut.train.n_epochs
    if launches["normalize_u8"] != val_batches:
        raise AssertionError(f"sharded fit: T2 launched "
                             f"{launches['normalize_u8']} times, expected "
                             f"{val_batches}")
    # the restored best epoch (first maximum of val_recall1) by the plain kNN
    vals = h[straight["monitor"]]
    best = int(np.argmax(vals))
    for key in ("val_recall1", "val_recall5"):
        if straight["plain_recall"][key] != h[key][best]:
            raise AssertionError(
                f"sharded fit: {key} {h[key][best]} of epoch {best} through "
                f"the sharded kNN, {straight['plain_recall'][key]} through "
                f"the plain kNN")
    print(f"sharded fit: the recall of the best epoch {best} through the "
          f"sharded kNN equals the plain kNN's: {straight['plain_recall']}")

    # resume from epoch 0's checkpoint in another work dir
    project = cut.general["project_name"]
    weights = os.path.join(tmp, "sharded_resume", project, "weights")
    os.makedirs(weights)
    shutil.copytree(os.path.join(tmp, "sharded_work", project, "weights",
                                 "0"), os.path.join(weights, "0"))
    resume_cfg = _fit_config(
        tmp, source=path, label="sharded fit", work="sharded_resume",
        name="resume.yml", cuts=[("GENERAL", "work_dir", None,
                                  "the resumed run's own dir")])
    resumed, took = _torchrun(resume_cfg, os.path.join(tmp, "resume.json"),
                              "--resume_from", "0")
    if resumed["digest"] != straight["digest"]:
        raise AssertionError(f"sharded fit: the run resumed from epoch 0 "
                             f"ends at {resumed['digest']}, the straight "
                             f"run at {straight['digest']}")
    for key, values in resumed["history"].items():
        if key.endswith("_s") or key == "images_per_sec":
            continue
        if values != h[key][1:]:
            raise AssertionError(f"sharded fit: resumed {key} {values}, "
                                 f"straight {h[key][1:]}")
    print(f"sharded fit: resumed from epoch 0 through torchrun in "
          f"{took:.1f} s: epoch 1's metrics and the final state (digest "
          f"{straight['digest']}) equal the straight run's bit for bit")
    return launches


def bf16_params_phase(smi, tmp):
    """(d) The flagship config with ``params_dtype: bfloat16`` through the
    port's Trainer (phase 9's cuts and dataset): one train step on the
    Trainer's first batch; every parameter, BatchNorm statistic and
    optimizer moment bf16, the loss finite."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    path = _fit_config(tmp, settings=[("PERFORMANCE", "params_dtype",
                                       "bfloat16")],
                       label="bf16 params", work="bf16_work", name="bf16.yml")
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device=DEVICE, log_fn=lambda *a: None)
    images, labels = next(trainer._device_prefetch(
        trainer._check_pk_layout(trainer._train_loader())))
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    trainer.state, m = trainer.train_step(trainer.state, images, labels)
    torch.cuda.synchronize()
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    floats = {k: v.dtype for k, v in trainer.module.state_dict().items()
              if v.is_floating_point()}
    moments = {v.dtype for s in trainer.state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.ndim}
    print(f"bf16 params: the Trainer's first step on the flagship config "
          f"(B={len(labels)}), loss {float(m['loss']):.4f}, {len(floats)} "
          f"float tensors of {set(floats.values())}, optimizer moments of "
          f"{moments}, launches {launches} [{smi}]")
    if set(floats.values()) != {torch.bfloat16} or moments != {
            torch.bfloat16}:
        raise AssertionError("bf16 params: a tensor is not bf16")
    if not np.isfinite(float(m["loss"])):
        raise AssertionError("bf16 params: the loss is not finite")
    _check_launches("bf16 params", launches, EXPECTED_AUG_PER_STEP, 1)


def data_parallel_phase(smi, tmp):
    """Phase 14: (a)-(d). Returns the launches of its runs, by kernel:
    (a)'s timed sharded steps, (b)'s remat step, (c)'s fit."""
    from embeddingnet_tpu_torch.config import parse_params
    t0 = time.perf_counter()
    params = parse_params(SHARDED_CONFIG)
    step_launches, _ = sharded_step_phase(smi, params)
    remat_launches = remat_check_phase(smi, params)
    fit_launches = sharded_fit_phase(smi, tmp)
    bf16_params_phase(smi, tmp)
    print(f"data parallel: phase 14 in {time.perf_counter() - t0:.1f} s")
    return {"sharded_step": step_launches, "remat_step": remat_launches,
            "sharded_fit": fit_launches}


# -- phase 15: the rest of the backbone zoo and pretrained weights ----------

# (a) the flagship config with backbone_name seresnet50 (the SE block sits
# after bn3, so each block's bn1 -> relu -> conv2 stays fused: the
# ResNet-50 step's launches), from MODEL.backbone_weights 'imagenet', which
# resolves through $EMBEDDINGNET_WEIGHTS_DIR to a .npz of a seeded port
# model's backbone; the Trainer's own step on colour-cell P-K batches
ZOO_BACKBONE = "seresnet50"
ZOO_SETTINGS = [("MODEL", "backbone_name", ZOO_BACKBONE),
                ("MODEL", "backbone_weights", "imagenet")]
ZOO_CUTS = [
    ("DATALOADER", "dataset_path", None, "phase 9's PNGs (the steps are fed "
                                         "colour-cell batches on the card)"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]
ZOO_WARMUP, ZOO_TIMED, ZOO_PROFILED = 3, 10, 2
# (b) one name per family at its smallest input, card against CPU from one
# state_dict in float64 train mode (as phase 13 (b), CARD_TOL): the
# embeddings, the batch-hard loss and every gradient. No float32 check: at
# random weights SENet-154's 50 blocks amplify float32 rounding past 1e-5
# (tests/test_torch_port_zoo_resnet.py)
ZOO_CARD_FAMILIES = (("seresnet18", 32), ("seresnext50", 32),
                     ("senet154", 32), ("densenet121", 32), ("vgg16", 32),
                     ("inceptionv3", 75), ("inceptionresnetv2", 75),
                     ("xception", 71), ("nasnetmobile", 32),
                     ("nasnetmobile", 33))
ZOO_CARD_BATCH = 8
# (c) an arcface fit from a weights preset: configs/vit_arcface_smoke.yml on
# a zoo backbone, cut to a small dataset
ZOO_FIT_BACKBONE = "densenet121"
ZOO_FIT_CLASSES, ZOO_FIT_PER_CLASS = 32, 8
ZOO_FIT_SETTINGS = [("MODEL", "backbone_name", ZOO_FIT_BACKBONE),
                    ("MODEL", "backbone_weights", "imagenet")]
ZOO_FIT_CUTS = [
    ("DATALOADER", "dataset_path", None, "no data on the machine"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", 4, "run time"),
    ("GENERATOR", "batch_size", 32, "the cut dataset"),
    ("TRAIN", "eval_recall_every", 1, "so recall runs every epoch"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]
# (d) each name this slice ported, an eval forward in bf16 at its native
# input (Keras' default size), B=32
ZOO_NATIVE = {"inceptionv3": 299, "inceptionresnetv2": 299, "xception": 299,
              "nasnetlarge": 331}
ZOO_NAMES = ("seresnet18", "seresnet34", "seresnet50", "seresnet101",
             "seresnet152", "resnext50", "resnext101", "seresnext50",
             "seresnext101", "senet154", "inceptionv3", "inceptionresnetv2",
             "xception", "nasnetmobile", "nasnetlarge", "densenet121",
             "densenet169", "densenet201", "vgg16", "vgg19")
ZOO_EVAL_BATCH = 32


def _write_weights(root, name, seed, **kw):
    """``<root>/<name>_imagenet.npz``: the backbone of a port model drawn
    from ``seed`` (its BatchNorm statistics drawn too), as the converters
    write a preset; returns the file's arrays."""
    from embeddingnet_tpu_torch.models import pretrained
    source = EmbeddingModule(name, **kw)
    source.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in source.backbone.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    flat = {k: v for k, v in pretrained.flatten_params(source).items()
            if k.split("/")[1] == "backbone"}
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, f"{name}_imagenet.npz"), **flat)
    return flat


def _check_loaded(label, module, flat, fresh):
    """Every backbone tensor of ``module`` equals the file's; every other
    one ``fresh``'s (the module as built, before the load)."""
    from embeddingnet_tpu_torch.models import pretrained
    got = pretrained.flatten_params(module)
    want = pretrained.flatten_params(fresh)
    n_file = n_fresh = 0
    for key, value in got.items():
        ref = flat.get(key)
        if ref is None:
            ref, n_fresh = want[key], n_fresh + 1
        else:
            n_file += 1
        if not np.array_equal(value, ref):
            source = "the file" if key in flat else "its fresh value"
            raise AssertionError(f"{label}: {key} differs from {source}")
    if n_file != len(flat):
        raise AssertionError(f"{label}: {len(flat) - n_file} of the file's "
                             f"arrays have no place in the module")
    print(f"{label}: loaded {n_file} arrays of the file bit for bit; "
          f"{n_fresh} others (the head) keep the fresh initialisation")


def _event_steps(state, step, batches):
    """Runs the steps; (per-step ms by CUDA events, metrics as floats)."""
    times, metrics = [], []
    for images, labels in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, images, labels)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics


def zoo_step_phase(smi, tmp):
    """Phase 15 (a): the flagship config on SE-ResNet-50 through the
    Trainer, from a weights preset: the load checked, then the Trainer's
    step on colour-cell batches with exact launches, a falling loss, CUDA
    event and profiler times, peak memory. Returns the timed steps'
    launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.models import pretrained
    from embeddingnet_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    weights = os.path.join(tmp, "weights")
    path = _fit_config(tmp, cuts=ZOO_CUTS, settings=ZOO_SETTINGS,
                       label="zoo step", work="zoo_work",
                       name="zoo_config.yml")
    params = parse_params(path)
    m, g = params.model, params.generator
    flat = _write_weights(weights, m.backbone_name, SEED + 20,
                          encodings_len=m.encodings_len)
    os.environ[pretrained.WEIGHTS_DIR_ENV] = weights
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device=DEVICE, log_fn=lambda *a: None)
    fresh = trainer._new_encoder()
    fresh.reset_parameters(torch.Generator().manual_seed(
        params.general.seed))
    _check_loaded("zoo step", trainer.module, flat, fresh)
    batch = g.k_classes * g.k_samples
    batches = _b3_batches(np.random.default_rng(SEED + 21),
                          ZOO_WARMUP + ZOO_TIMED + ZOO_PROFILED, batch,
                          m.input_shape[0])
    state, step = trainer.state, trainer.train_step
    _event_steps(state, step, batches[:ZOO_WARMUP])
    print(f"zoo step: {m.backbone_name} from {m.backbone_weights!r} "
          f"({sum(p.numel() for p in trainer.module.parameters()) / 1e6:.2f}"
          f" M parameters), {params.performance.compute_dtype}, B={batch}, "
          f"{g.negatives_selection_mode}, augmentation {g.augmentations!r}; "
          f"built, loaded and {ZOO_WARMUP} warm-up steps in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the SE-ResNet-50 step's path: every launch count from here to the
    # reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    timed = batches[ZOO_WARMUP:ZOO_WARMUP + ZOO_TIMED]
    times, metrics = _event_steps(state, step, timed)
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the SE-ResNet-50 step's path ----
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    print(f"zoo step: {ZOO_TIMED} steps, CUDA events: median {med:.2f} ms "
          f"(min {min(times):.2f}, max {max(times):.2f}), "
          f"{batch / med * 1e3:.0f} img/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{smi}]")
    _check_training("zoo step", metrics, launches, EXPECTED_AUG_PER_STEP,
                    ZOO_TIMED)
    busy, dev_ms, ours, top, _, augment = _device_busy(
        state, step, batches[ZOO_WARMUP + ZOO_TIMED:])
    print(f"zoo step: torch.profiler over {ZOO_PROFILED} steps: "
          f"{dev_ms:.2f} ms of device time per step, busy {busy:.3f} of the "
          f"profiled wall, {dev_ms / med:.3f} of the event median; the "
          f"augmentation {augment['ms']:.2f} ms, the port's kernels "
          f"{sum(ours.values()) * 1e-3 / ZOO_PROFILED:.2f} ms per step "
          f"[{smi}]")
    for name, us in top:
        print(f"  profile top: {us / ZOO_PROFILED / 1e3:8.3f} ms/step  "
              f"{name[:90]}")
    del trainer, state, step, batches, fresh
    torch.cuda.empty_cache()
    return launches


def zoo_card_check():
    """Phase 15 (b): each zoo family at its smallest input, on the card
    against the CPU from one state_dict, float64 train mode."""
    import copy
    from embeddingnet_tpu_torch.ops.mining import mined_triplet_loss
    rng = np.random.default_rng(SEED + 22)
    labels = torch.arange(ZOO_CARD_BATCH // 4).repeat_interleave(4)
    for name, size in ZOO_CARD_FAMILIES:
        t0 = time.perf_counter()
        cpu = EmbeddingModule(name, encodings_len=64, classifier=False)
        cpu.reset_parameters(torch.Generator().manual_seed(SEED))
        images = torch.from_numpy(rng.uniform(
            0, 1, (ZOO_CARD_BATCH, size, size, 3)))
        out = {}
        for where in ("cpu", "card"):
            device = "cpu" if where == "cpu" else DEVICE
            module = copy.deepcopy(cpu).double().train().to(device)
            emb = module(images.to(device))
            loss, _ = mined_triplet_loss(emb, labels.to(device),
                                         margin=MARGIN, mode="batch_hard")
            loss.backward()
            out[where] = (emb.detach().cpu(), loss.item(), {
                n: p.grad.cpu() for n, p in module.named_parameters()})
            del module
        (e_cpu, l_cpu, g_cpu), (e_card, l_card, g_card) = (
            out["cpu"], out["card"])
        zero = _zero_in_exact_arithmetic(g_cpu)
        top = max(g.abs().max().item() for g in g_cpu.values())
        worst = {"embeddings": ((e_card - e_cpu).abs().max()
                                / e_cpu.abs().max()).item(),
                 "loss": abs(l_card - l_cpu) / abs(l_cpu)}
        for n, grad in g_cpu.items():
            scale = top if n in zero else grad.abs().max().item()
            worst[n] = (g_card[n] - grad).abs().max().item() / scale
        key = max(worst, key=worst.get)
        print(f"zoo card check {name} at {size} px, B={ZOO_CARD_BATCH}: "
              f"float64 embeddings {worst['embeddings']:.2e}, loss "
              f"{l_card:.6f} against {l_cpu:.6f} ({worst['loss']:.2e}); "
              f"worst of {len(g_cpu)} gradients ({len(zero)} zero in exact "
              f"arithmetic) and the rest: {key} {worst[key]:.2e}; tolerance "
              f"{CARD_TOL:g}; {time.perf_counter() - t0:.1f} s")
        if not all(np.isfinite(list(worst.values()))) or \
                worst[key] > CARD_TOL:
            raise AssertionError(f"zoo card check {name}: {key} off by "
                                 f"{worst[key]:.2e}")
    torch.cuda.empty_cache()


def zoo_fit_phase(smi, tmp):
    """Phase 15 (c): configs/vit_arcface_smoke.yml on a zoo backbone from a
    weights preset, fitted through the Trainer in arcface mode (the file
    loads into the encoder), every kernel at 0 launches, then a second
    Trainer's resume bit for bit. Returns the fit's launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.models import pretrained
    from embeddingnet_tpu_torch.train.loop import Trainer
    root = os.path.join(tmp, "zoo_fit")
    t0 = time.perf_counter()
    _write_fit_dataset(os.path.join(root, "dataset"), ZOO_FIT_CLASSES,
                       ZOO_FIT_PER_CLASS, VIT_FIT_SIZE)
    path = _fit_config(root, source=VIT_SMOKE_CONFIG, cuts=ZOO_FIT_CUTS,
                       settings=ZOO_FIT_SETTINGS, label="zoo fit")
    params = parse_params(path)
    m = params.model
    weights = os.path.join(root, "weights")
    flat = _write_weights(weights, m.backbone_name, SEED + 23,
                          encodings_len=m.encodings_len,
                          embeddings_normalization=False, classifier=False)
    os.environ[pretrained.WEIGHTS_DIR_ENV] = weights
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    logs = []
    trainer = Trainer(params, loader, device=DEVICE, log_fn=logs.append)
    if trainer.mode != "arcface":
        raise AssertionError(f"zoo fit: mode {trainer.mode}")
    fresh = trainer._new_encoder()
    fresh.reset_parameters(torch.Generator().manual_seed(
        params.general.seed))
    _check_loaded("zoo fit", trainer.encoder, flat, fresh)
    if not any("loaded backbone weights" in str(line) for line in logs):
        raise AssertionError("zoo fit: the Trainer logged no load")
    print(f"zoo fit: {m.backbone_name} in arcface mode, the file loaded "
          f"into the encoder; set up in {time.perf_counter() - t0:.1f} s")

    # ---- the zoo fit's path: every launch count from here to the reading
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.fit().history
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the zoo fit's path ----
    for e, timing in enumerate(trainer.timings):
        print(f"zoo fit: epoch {e}: loss {history['loss'][e]:.4f}, recall@1 "
              f"{history['val_recall1'][e]:.4f}, {timing['epoch_s']:.2f} s, "
              f"images_per_sec {history['images_per_sec'][e]:.0f} [{smi}]")
    print(f"zoo fit: {fit_s:.1f} s; launches {launches}")
    if not np.all(np.isfinite(history["loss"])):
        raise AssertionError("zoo fit: loss not finite")
    if not all(0 <= v <= 1 for v in history["val_recall1"]):
        raise AssertionError(f"zoo fit: recall {history['val_recall1']}")
    if any(launches.values()):
        raise AssertionError(f"zoo fit: a kernel launched: {launches}")
    _resume_check("zoo fit", params, loader, trainer)
    del trainer, fresh
    torch.cuda.empty_cache()
    return launches


def zoo_eval_phase(smi):
    """Phase 15 (d): each name this slice ported, an eval forward in bf16
    at its native input, B=ZOO_EVAL_BATCH: CUDA-event ms and peak memory.
    Returns the launches over the timed forwards."""
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    for name in ZOO_NAMES:
        size = ZOO_NATIVE.get(name, 224)
        t0 = time.perf_counter()
        with torch.device(DEVICE):
            module = EmbeddingModule(name, dtype=torch.bfloat16,
                                     classifier=False)
        module.reset_parameters(torch.Generator(DEVICE).manual_seed(SEED))
        module.eval()
        x = torch.rand(ZOO_EVAL_BATCH, size, size, 3, device=DEVICE)
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = cuda_ms(lambda: module(x), iters=5, warmup=2)
            out = module(x)
        peak = torch.cuda.max_memory_allocated()
        if out.shape != (ZOO_EVAL_BATCH, 256) or not torch.isfinite(
                out.float()).all():
            raise AssertionError(f"zoo eval {name}: {tuple(out.shape)}")
        print(f"zoo eval {name} at {size} px, bf16, B={ZOO_EVAL_BATCH}: "
              f"{ms:.2f} ms a forward ({ZOO_EVAL_BATCH / ms * 1e3:.0f} "
              f"img/s), peak memory {peak / 2 ** 30:.2f} GiB, "
              f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f} M "
              f"parameters, built in {build_s:.1f} s [{smi}]")
        del module, x, out
        torch.cuda.empty_cache()
    return {**fc.LAUNCHES, **pre.LAUNCHES}


def zoo_phase(smi, tmp):
    """Phase 15: (a)-(d). Returns the launches of its runs, by kernel."""
    t0 = time.perf_counter()
    step_launches = zoo_step_phase(smi, tmp)
    zoo_card_check()
    fit_launches = zoo_fit_phase(smi, tmp)
    eval_launches = zoo_eval_phase(smi)
    print(f"zoo: phase 15 in {time.perf_counter() - t0:.1f} s")
    return {"seresnet50_step": step_launches, "zoo_fit": fit_launches,
            "zoo_eval": eval_launches}


# -- phase 16: the native decoder, tensor parallelism, the pipeline, the
# quickstart twin ------------------------------------------------------------

TP_CHILD_FLAG = "--tp-child"
# (a): phase 9's PNGs plus these JPEGs, decoded to the flagship's 64 px
DECODE_JPEGS, DECODE_JPEG_SIZE, DECODE_QUALITY, DECODE_SIZE = 512, 256, 90, 64
# the exact native path against cv2: the bilinear's rounding (F1)
DECODE_MAX_DIFF = 1
# (b): configs/vit_arcface.yml with MESH.model 2 on 2 gloo ranks of the one
# card, against the one-process step from the same weights and batch
TP_VIT_BATCH, TP_TIMED = 256, 3
# bf16 on both sides, the TP side summing partial products of bf16 matmuls
# (each rounded to bf16) where one process rounds the whole product once:
# the loss to TP_LOSS_RTOL; the gradient, all parameters together, to
# TP_GRAD_REL in relative L2; the parameters after the step (Adam's first
# update is lr * sign(g) at the warm-up's lr0) differ by 2 * lr0 where the
# signs differ, on at most TP_FLIP_MAX of the entries
TP_LOSS_RTOL, TP_GRAD_REL, TP_FLIP_MAX = 2e-2, 5e-2, 2e-2
TP_RESNET_CUTS = [
    ("DATALOADER", "dataset_path", None, "phase 9's PNGs"),
    ("GENERATOR", "n_batches", 2, "run time: 2 steps"),
    ("TRAIN", "n_epochs", 1, "run time"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    ("TRAIN", "plot_history", False, "the card's machine has no "
                                     "matplotlib"),
    ("GENERAL", "work_dir", None, "a temp dir"),
]
TP_RESNET_SETTINGS = [("MESH", "model", 2), ("MESH", "data", -1)]
# (c): ViT-B/16's blocks, 2 stages, bf16, against the blocks in order on
# the whole batch: output and each stage's gradient to PIPE_TOL of the
# tensor's largest entry (bf16 products of microbatches of 8 rows against
# those of 32)
PIPE_BATCH, PIPE_MICRO, PIPE_TOL = 32, 4, 2e-2
QUICKSTART = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "quickstart_torch.py")


def _write_jpegs(root, n=DECODE_JPEGS, size=DECODE_JPEG_SIZE):
    """``n`` seeded JPEGs (quality DECODE_QUALITY) of colour cells with
    noise at ``size`` px, written with cv2."""
    import cv2
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(SEED + 60)
    images = cell_images(rng, rng.integers(0, 64, n), size=size)
    paths = []
    for i, img in enumerate(images):
        path = os.path.join(root, f"{i}.jpg")
        if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY,
                                       DECODE_QUALITY]):
            raise OSError(f"cv2 could not write {path}")
        paths.append(path)
    return paths


def _cv2_decode(paths, size, threads=8):
    """cv2 on ``threads`` threads, as ``BatchLoader(backend="python")``
    decodes: ``(images, seconds)``."""
    from concurrent.futures import ThreadPoolExecutor
    from embeddingnet_tpu_torch.data.images import get_image
    out = np.zeros((len(paths), size, size, 3), np.uint8)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        for i, im in enumerate(pool.map(
                lambda p: get_image(p, (size, size, 3)), paths)):
            out[i] = im
    return out, time.perf_counter() - t0


def decoder_phase(smi, tmp):
    """(a) The native decoder: its rates and differences against cv2 on
    phase 9's PNGs and DECODE_JPEGS JPEGs, then phase 9's fit and phase 13
    (d)'s encode_dataset on it, beside their cv2 numbers. Where the decoder
    cannot be built (no libjpeg/libpng headers), the documented behaviour:
    an ``unavailable`` line, ``auto`` resolved to cv2. Returns the native
    fit's launches (None without the decoder)."""
    from embeddingnet_tpu_torch.data import native_loader
    from embeddingnet_tpu_torch.data.pipeline import BatchLoader
    pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(tmp, "dataset")) for f in fs if f.endswith(".png"))
    jpegs = _write_jpegs(os.path.join(tmp, "jpegs"))
    paths = pngs + jpegs
    cv2_images, cv2_s = _cv2_decode(paths, DECODE_SIZE)
    print(f"decoder: cv2 on 8 threads: {len(pngs)} PNGs at 64 px and "
          f"{len(jpegs)} JPEGs at {DECODE_JPEG_SIZE} px (quality "
          f"{DECODE_QUALITY}) to {DECODE_SIZE} px in {cv2_s:.2f} s, "
          f"{len(paths) / cv2_s:.0f} img/s [{smi}]")
    resolved = BatchLoader([], (DECODE_SIZE, DECODE_SIZE, 3)).backend
    if not native_loader.available():
        print(f"native_decoder: unavailable: "
              f"{native_loader.unavailable_reason()}")
        if resolved != "python":
            raise AssertionError(f"decoder: auto resolved to {resolved} "
                                 f"without the native decoder")
        print("decoder: BatchLoader's auto resolves to cv2 (python), as "
              "the JAX loader's does without its decoder; the fit and "
              "encode of phases 9 and 13 decoded with cv2")
        return None
    if resolved != "native":
        raise AssertionError(f"decoder: auto resolved to {resolved} on "
                             f"{os.cpu_count()} cores")
    rates = {}
    for fast in (False, True):
        native_loader.decode_batch(paths[:64], DECODE_SIZE, DECODE_SIZE)
        t0 = time.perf_counter()
        got = native_loader.decode_batch(paths, DECODE_SIZE, DECODE_SIZE,
                                         n_threads=8, fast=fast)
        rates[fast] = (got, len(paths) / (time.perf_counter() - t0))
    exact, fast = rates[False][0], rates[True][0]
    worst = int(np.abs(exact.astype(int) - cv2_images.astype(int)).max())
    diff = np.abs(fast[len(pngs):].astype(int)
                  - exact[len(pngs):].astype(int))
    print(f"decoder: native exact {rates[False][1]:.0f} img/s, fast "
          f"{rates[True][1]:.0f} img/s (8 threads), cv2 "
          f"{len(paths) / cv2_s:.0f} img/s [{smi}]; exact against cv2: "
          f"largest difference {worst} gray level(s) (at most "
          f"{DECODE_MAX_DIFF}); fast against exact on the JPEGs: mean "
          f"{diff.mean():.3f}, p99 {np.percentile(diff, 99):.0f} levels")
    if worst > DECODE_MAX_DIFF:
        raise AssertionError(f"decoder: exact path {worst} levels from cv2")
    if not np.array_equal(fast[:len(pngs)], exact[:len(pngs)]):
        raise AssertionError("decoder: the fast path changed a PNG")
    return _native_fit(smi, tmp)


def _native_fit(smi, tmp):
    """Phase 9's fit config again, its loaders on the native decoder, and
    phase 13 (d)'s encode_dataset on its export; prints both beside the
    cv2 numbers. Returns the fit's launches."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    path = _fit_config(tmp, label="native fit", work="native_work",
                       name="native.yml")
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device=DEVICE)
    backend = trainer._train_loader().backend
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    history = trainer.fit().history
    torch.cuda.synchronize()
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    cv2_fit = CV2_NUMBERS.get("fit", {})
    print(f"native fit: loaders on {backend}; epoch walls "
          + ", ".join(f"{t['epoch_s']:.2f}" for t in trainer.timings)
          + " s, images_per_sec " + ", ".join(
              f"{v:.0f}" for v in history["images_per_sec"])
          + f"; phase 9 on {cv2_fit.get('backend')}: epoch walls "
          + ", ".join(f"{v:.2f}" for v in cv2_fit.get("epoch_s", []))
          + " s, images_per_sec " + ", ".join(
              f"{v:.0f}" for v in cv2_fit.get("images_per_sec", []))
          + f" [{smi}]")
    if backend != "native" or not np.all(np.isfinite(history["loss"])):
        raise AssertionError(f"native fit: {backend}, {history['loss']}")
    net = EmbeddingNet(params, device=DEVICE,
                       fast_conv=params.performance.pallas_conv,
                       dtype=trainer.compute_dtype)
    net.load_encoder_state(trainer.encoder_variables())
    paths = loader.flat("train")[0] + loader.flat("val")[0]
    net.encode_dataset(paths[:DB_BATCH], batch_size=DB_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = net.encode_dataset(paths, batch_size=DB_BATCH)
    rate = len(paths) / (time.perf_counter() - t0)
    print(f"native fit: encode_dataset of {len(paths)} PNGs at {rate:.0f} "
          f"img/s on the native decoder; phase 13 (d) "
          f"{CV2_NUMBERS.get('encode', {}).get('img_s', float('nan')):.0f} "
          f"img/s [{smi}]")
    if not np.isfinite(emb).all():
        raise AssertionError("native fit: encodings not finite")
    return launches


def _tp_torchrun(kind, out, *args, nproc=2, timeout=600):
    """``torchrun --nproc_per_node=nproc chip_smoke.py --tp-child KIND OUT
    ARGS`` on gloo ranks that share the card; each rank writes
    ``OUT.rank<r>.json`` (and rank 0 ``OUT.pt`` where the kind has
    tensors). Returns the ranks' JSON and the seconds the launch took."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", "--master_port", str(_free_port()),
           os.path.abspath(__file__), TP_CHILD_FLAG, kind, out, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    took = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("[rank", "tp ", "pipeline")):
            print(f"  [torchrun] {line[:300]}")
    if proc.returncode:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise AssertionError(f"torchrun --tp-child {kind} exited "
                             f"{proc.returncode}")
    runs = []
    for r in range(nproc):
        with open(f"{out}.rank{r}.json") as f:
            runs.append(json.load(f))
    return runs, took


def _tp_child(argv):
    """A rank of phase 16's two-rank runs (``--tp-child KIND OUT
    [ARGS]``): gloo on the shared card, a (1, 2) grid, TF32 off."""
    import torch.distributed as dist
    from embeddingnet_tpu_torch.parallel import mesh
    kind, out, args = argv[0], argv[1], argv[2:]
    mesh.maybe_initialize_distributed(DEVICE, backend="gloo")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    grid = mesh.build_grid(1, 2)
    try:
        result = {"vit": _tp_vit_child, "resnet": _tp_resnet_child,
                  "pipeline": _pipeline_child}[kind](grid, out, *args)
        result["rank"] = dist.get_rank()
        with open(f"{out}.rank{dist.get_rank()}.json", "w") as f:
            json.dump(result, f)
    finally:
        mesh.reset_grid()
        dist.destroy_process_group()


def _grads(module, tp=None):
    """Every parameter's gradient as a whole f32 host tensor (the slices of
    a split module gathered over ``tp``)."""
    from embeddingnet_tpu_torch.parallel.collectives import gather_slices
    shards = getattr(module, "tp_shards", None) or {}
    return {n: (gather_slices(p.grad, *shards[n], tp) if n in shards
                else p.grad).float().cpu()
            for n, p in module.named_parameters()}


def _tp_vit_step(label, tp=None, parallel=None):
    """configs/vit_arcface.yml's ArcFace step (its module from SEED, split
    over ``tp``) on one batch of TP_VIT_BATCH: the loss, the whole
    gradients and parameters after it, then TP_TIMED timed steps (ms each)
    and the peak memory."""
    from embeddingnet_tpu_torch.parallel.tp import gather_module_state
    module, state, step, batch, shape, _, _ = _arcface_from_config(
        VIT_CONFIG, label, batch=TP_VIT_BATCH, tp=tp, parallel=parallel)
    batches = _vit_batches(shape, batch, 1 + TP_TIMED, SEED + 40)
    cores = _att_reset()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, *batches[0])
    loss = metrics["loss"].item()
    grads = _grads(module, tp)
    after = {k: v.float().cpu()
             for k, v in gather_module_state(module).items()}
    times = []
    for images, labels in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, images, labels)
        metrics["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    attention = _att_read(label, cores,
                          bwd=_att_layers(module) * len(batches))
    return {"loss": loss, "grads": grads, "after": after, "times": times,
            "peak": peak, "attention": attention}


def _tp_vit_child(grid, out):
    import torch.distributed as dist
    from embeddingnet_tpu_torch.parallel.collectives import (DataParallel,
                                                             ModelParallel)
    run = _tp_vit_step(f"tp rank {dist.get_rank()}",
                       ModelParallel.current(), DataParallel.current())
    if dist.get_rank() == 0:
        torch.save({k: run[k] for k in ("loss", "grads", "after")},
                   out + ".pt")
    return {"loss": run["loss"], "times_ms": run["times"],
            "peak": run["peak"], "grid": list(grid[:4]),
            "attention": run["attention"]}


def _tp_resnet_child(grid, out, cfg):
    """The flagship config at MESH.model 2 through the Trainer: its train
    epoch of 2 steps, the launches of each kernel over it."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    params = parse_params(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device=DEVICE,
                      log_fn=lambda *a, **k: None)
    trainer._current_epoch = 0
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    metrics = trainer._run_train_epoch()
    torch.cuda.synchronize()
    return {"launches": {**fc.LAUNCHES, **pre.LAUNCHES},
            "loss": metrics["loss"], "grid": list(grid[:2]),
            "split": sorted(getattr(trainer.module, "tp_shards", None)
                            or {}), "data": trainer.parallel.size,
            "images_per_sec": metrics["images_per_sec"]}


def _vit_b16_blocks():
    """ViT-B/16's 12 encoder blocks (224 px, bf16 compute), random weights
    from SEED on the card."""
    from embeddingnet_tpu_torch.models.vit import build_vit
    vit = build_vit("vit-b16", (224, 224, 3), dtype=torch.bfloat16)
    vit.reset_parameters(torch.Generator().manual_seed(SEED))
    vit.to(DEVICE)
    return [getattr(vit, f"block{i + 1}") for i in range(vit.depth)]


def _pipeline_child(grid, out):
    """(c) ViT-B/16's blocks through 2 stages against the blocks applied in
    order on the whole batch, on this rank: the output, this stage's
    gradient of ``sum(y ** 2)``, and both runs' times."""
    import torch.distributed as dist
    from embeddingnet_tpu_torch.parallel import pp
    blocks = _vit_b16_blocks()
    x = torch.randn((PIPE_BATCH, 197, 768),
                    generator=torch.Generator().manual_seed(SEED + 70)
                    ).to(DEVICE, torch.bfloat16)
    stacked = pp.stack_stage_params(
        [{k: v.detach() for k, v in b.named_parameters()} for b in blocks],
        grid.model)
    params = pp.place_stage_params(stacked, grid, device=DEVICE)
    for v in params.values():
        v.requires_grad_(True)
    cores = _att_reset()

    def block_apply(p, h):
        return torch.func.functional_call(blocks[0], p, (h,))

    def pipeline():
        y = pp.pipeline_blocks_forward(block_apply, params, x, grid,
                                       n_micro=PIPE_MICRO)
        names = list(params)
        g = torch.autograd.grad((y.float() ** 2).sum(),
                                [params[n] for n in names])
        return y, dict(zip(names, g))

    def sequential():
        y = x
        for b in blocks:
            y = b(y)
        loss = (y.float() ** 2).sum()
        return y, torch.autograd.grad(loss, [p for b in blocks
                                             for p in b.parameters()])

    y, grads = pipeline()
    want_y, want_g = sequential()
    names = [n for n, _ in blocks[0].named_parameters()]
    per = len(blocks) // grid.model
    stage = grid.m
    worst = {"out": float((y.float() - want_y.float()).abs().max()
                          / want_y.float().abs().max())}
    for i in range(per):
        for j, n in enumerate(names):
            ref = want_g[(stage * per + i) * len(names) + j].float()
            gap = float((grads[n][i].float() - ref).abs().max()
                        / ref.abs().max().clamp_min(1e-30))
            worst[n] = max(worst.get(n, 0.0), gap)
    times = {}
    for label, fn in (("pipeline", pipeline), ("sequential", sequential)):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) * 1e3
    attention = _att_read(f"pipeline stage {stage}", cores)
    return {"worst": worst, "times_ms": times, "stage": stage,
            "attention": attention}


def tp_vit_phase(smi, tmp):
    """(b) ViT-B/16 ArcFace (configs/vit_arcface.yml) at MESH.model 2 on
    two gloo ranks of the card against the one-process step."""
    from embeddingnet_tpu_torch.config import parse_params
    t0 = time.perf_counter()
    one = _tp_vit_step("tp one-process")
    cfg = parse_params(VIT_CONFIG)
    t, g = cfg.train, cfg.generator
    lr0 = step_decay_schedule(t.learning_rate, t.decay_factor, t.step_size,
                              g.n_batches, warmup_epochs=t.warmup_epochs)(0)
    torch.cuda.empty_cache()
    print(f"tp one-process: ViT-B/16 ArcFace step B={TP_VIT_BATCH}: loss "
          f"{one['loss']:.6f}, timed steps "
          + ", ".join(f"{t:.1f}" for t in one["times"])
          + f" ms, peak {one['peak'] / 2 ** 30:.2f} GiB [{smi}]")
    out = os.path.join(tmp, "tp_vit")
    runs, took = _tp_torchrun("vit", out)
    tp = torch.load(out + ".pt", weights_only=True)
    for run in runs:
        ATT_LAUNCHES[f"tp rank {run['rank']}"] = run["attention"]
        print(f"tp: rank {run['rank']} (grid {run['grid']}): timed steps "
              + ", ".join(f"{t:.1f}" for t in run["times_ms"])
              + f" ms, peak {run['peak'] / 2 ** 30:.2f} GiB [{smi}]")
    loss_gap = abs(tp["loss"] - one["loss"]) / abs(one["loss"])
    num = sum(float((tp["grads"][n] - g).square().sum())
              for n, g in one["grads"].items())
    den = sum(float(g.square().sum()) for g in one["grads"].values())
    grad_rel = (num / den) ** 0.5
    worst = max(one["grads"], key=lambda n: float(
        (tp["grads"][n] - one["grads"][n]).norm()
        / one["grads"][n].norm().clamp_min(1e-30)))
    total = sum(v.numel() for v in one["after"].values())
    flips = sum(int(((tp["after"][n] - v).abs() > lr0).sum())
                for n, v in one["after"].items())
    moved = max(float((tp["after"][n] - v).abs().max())
                for n, v in one["after"].items())
    print(f"tp: 2 ranks of MESH.model 2 (gloo, one card) in {took:.1f} s "
          f"(process start included): first-step loss {tp['loss']:.6f} "
          f"against one process {one['loss']:.6f} (relative {loss_gap:.2e}"
          f", limit {TP_LOSS_RTOL}); gradient relative L2 {grad_rel:.3e} "
          f"(limit {TP_GRAD_REL}; worst tensor {worst}); parameters after "
          f"it: {flips} of {total} entries ({flips / total:.2e}, limit "
          f"{TP_FLIP_MAX}) apart by more than lr0 {lr0:.1e}, largest gap "
          f"{moved:.2e} [{smi}]")
    if (loss_gap > TP_LOSS_RTOL or grad_rel > TP_GRAD_REL
            or flips / total > TP_FLIP_MAX):
        raise AssertionError("tp: the two-rank step is not the one-process "
                             "step")
    if any(run["loss"] != runs[0]["loss"] for run in runs):
        raise AssertionError("tp: the ranks' losses differ")
    print(f"tp: phase 16 (b) ViT in {time.perf_counter() - t0:.1f} s "
          f"[{smi}]")


def tp_resnet_phase(smi, tmp):
    """(b) the flagship config at MESH.model 2 (no rule matches a CNN: each
    rank runs the whole step) through the Trainer on 2 gloo ranks: its 2
    steps' launches on each rank, equal, and equal to phase 8's per step.
    Returns each rank's launches."""
    path = _fit_config(tmp, cuts=TP_RESNET_CUTS,
                       settings=TP_RESNET_SETTINGS, label="tp resnet",
                       work="tp_resnet_work", name="tp_resnet.yml")
    from embeddingnet_tpu_torch.config import parse_params
    steps = parse_params(path).generator.n_batches
    expected = {name: n * steps for name, n in
                EXPECTED_AUG_PER_STEP.items()}
    runs, took = _tp_torchrun("resnet", os.path.join(tmp, "tp_resnet"),
                              path)
    for run in runs:
        print(f"tp resnet: rank {run['rank']} grid {run['grid']}, data "
              f"axis {run['data']}, split {run['split']}: loss "
              f"{run['loss']:.4f}, {run['images_per_sec']:.0f} img/s, "
              f"launches {run['launches']} (expected {expected}) [{smi}]")
        for name, n in expected.items():
            if run["launches"][name] != n:
                raise AssertionError(f"tp resnet: rank {run['rank']} "
                                     f"launched {name} "
                                     f"{run['launches'][name]} times, "
                                     f"expected {n}")
        if run["split"]:
            raise AssertionError("tp resnet: a rule split a CNN")
    if runs[0]["loss"] != runs[1]["loss"]:
        raise AssertionError("tp resnet: the ranks' losses differ")
    print(f"tp resnet: in {took:.1f} s [{smi}]")
    return {f"tp_resnet_rank{run['rank']}": run["launches"] for run in runs}


def pipeline_phase(smi, tmp):
    """(c) GPipe over 2 gloo ranks: ViT-B/16's 12 blocks, n_micro 4, B=32,
    bf16, against the blocks in order."""
    runs, took = _tp_torchrun("pipeline", os.path.join(tmp, "pipeline"))
    for run in runs:
        ATT_LAUNCHES[f"pipeline stage {run['stage']}"] = run["attention"]
        worst = max(run["worst"].items(), key=lambda kv: kv[1])
        print(f"pipeline: stage {run['stage']}: output and gradient against "
              f"the sequential blocks, worst {worst[0]} "
              f"{worst[1]:.3e} of the largest entry (limit {PIPE_TOL}); "
              f"fwd+bwd {run['times_ms']['pipeline']:.1f} ms pipelined, "
              f"{run['times_ms']['sequential']:.1f} ms sequential on one "
              f"rank [{smi}]")
        if worst[1] > PIPE_TOL:
            raise AssertionError(f"pipeline: {worst}")
    print(f"pipeline: in {took:.1f} s [{smi}]")


def quickstart_phase(smi, tmp):
    """(d) examples/quickstart_torch.py on the card, end to end."""
    t0 = time.perf_counter()
    out = runpy.run_path(QUICKSTART)["main"](
        ["--device", DEVICE, "--work_dir", os.path.join(tmp, "quickstart")])
    h = out["history"]
    print(f"quickstart: {len(h['loss'])} epochs, loss "
          + " ".join(f"{v:.4f}" for v in h["loss"])
          + f"; query {out['query'][0]} -> {out['query'][1]}; val recall "
          f"top1 {out['recall']['top1']:.3f} top5 "
          f"{out['recall']['top5']:.3f}; in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    if not np.all(np.isfinite(h["loss"])):
        raise AssertionError("quickstart: loss not finite")
    for key in ("weights", "encodings"):
        if not os.path.exists(out[key]):
            raise AssertionError(f"quickstart: no {key}")


def phase16(smi, tmp):
    """Phase 16: (a) the native decoder, (b) tensor parallelism, (c) the
    pipeline, (d) the quickstart twin. Returns the launches of its runs:
    the native fit's (where the decoder builds) and each TP rank's."""
    t0 = time.perf_counter()
    launches = {}
    native = decoder_phase(smi, tmp)
    if native is not None:
        launches["native_fit"] = native
    tp_vit_phase(smi, tmp)
    launches.update(tp_resnet_phase(smi, tmp))
    pipeline_phase(smi, tmp)
    quickstart_phase(smi, tmp)
    print(f"phase 16 in {time.perf_counter() - t0:.1f} s [{smi}]")
    return launches


def main():
    smi = check_card()
    # f32 references in full f32: cuDNN's convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    records = {}
    forward_kernel_phase(records)
    backward_kernel_phase(records)
    normalize_kernel_phase(records)
    batchnorm_kernel_phase(records)
    attention_kernel_phase(records)
    epilogue_kernel_phase(records)
    tool_launches, t1_device_ms = epilogue_tool_phase()
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    serve_launches, db_images, db_classes = serving_phase()
    augmentation_check_phase(db_images)
    plain_launches = training_phase(db_images, db_classes)
    train_launches, device, step_images_per_s, cell_db = (
        augmented_training_phase(db_classes))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        fit_launches = fit_phase(smi, step_images_per_s, tmp)
        mining_rows = mining_phase(smi, cell_db, db_classes)
        del cell_db
        warmup_fit_phase(tmp)
        siamese_launches = siamese_phase(smi, tmp)
        vit_launches = vit_phase(smi, tmp)
        road_launches, inference_launches = depthwise_phase(smi, tmp)
        dp_launches = data_parallel_phase(smi, tmp)
        zoo_launches = zoo_phase(smi, tmp)
        p16_launches = phase16(smi, tmp)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    device["conv3x3_small_affine_relu"] = t1_device_ms

    lines, step_sum = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, (route, source, replaces) in KERNELS.items():
        if name in bnk.LAUNCHES:
            lines.append(_bn_kernel_line(name, route, source, replaces,
                                         records["batchnorm"],
                                         train_launches[name]))
            continue
        if name.startswith("attention_"):
            lines.append(_att_kernel_line(name, route, source, replaces,
                                          records["attention"]))
            continue
        rec = records[name]
        launches = train_launches[name]
        per = f"augmented training step, B={TRAIN_BATCH}"
        if name == "normalize_u8":
            row = rec["shapes"][0]
            sums = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                "device_ms", "library_device_ms", "cold_ms",
                "library_cold_ms", "cold_after_read_ms",
                "library_cold_after_read_ms", "host_us", "library_host_us",
                "alloc_host_us")}
            launches = plain_launches[name]
            per = f"training step without augmentation, B={TRAIN_BATCH}"
        elif name == "conv3x3_small_affine_relu":
            row, = [r for r in rec["shapes"] if (r["B"], r["S"], r["C"])
                    == (TOOL_BATCH, TOOL_S, TOOL_C)]
            sums = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                "kernel_device_ms", "conv2d_ms", "eager_sequence_ms",
                "conv2d_device_ms", "eager_sequence_device_ms")}
            launches = tool_launches
            per = (f"one call of the A/B tool's path, B={TOOL_BATCH}, "
                   f"S={TOOL_S}, C={TOOL_C}")
        elif name == "conv3x3_small":
            sums = _sum(rec, SIAMESE_BATCH, SIAMESE_K1_SHAPES)
            launches = siamese_launches[name]
            per = (f"siamese train step (configs/siamese_resnet18_pairs.yml,"
                   f" two streams of B={SIAMESE_BATCH})")
        else:
            sums = _sum(rec, TRAIN_BATCH, PER_STEP[name])
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": launches,
                 "fit_launches": fit_launches[name],
                 "siamese_fit_launches": siamese_launches[name],
                 "vit_fit_launches": vit_launches[name],
                 "road_signs_fit_launches": road_launches[name],
                 "inference_launches": inference_launches[name],
                 "phase14_launches": {run: counts[name] for run, counts
                                      in dp_launches.items()},
                 "phase15_launches": {run: counts[name] for run, counts
                                      in zoo_launches.items()},
                 "phase16_launches": {run: counts[name] for run, counts
                                      in p16_launches.items()},
                 "max_abs_err": rec["max_abs_err"], **sums, "per": per}
        if name in LIBRARY_RATIO:
            entry["library_ratio"] = sums["ms"] / sums["library_ms"]
            entry["library_ratio_device"] = (sums["kernel_device_ms"]
                                             / sums["library_device_ms"])
        if name in PROFILED_NAMES:
            entry["device_ms"] = device[name]
        if name == "conv3x3_small_bn_relu":
            entry["serve"] = {"launches": serve_launches[name],
                              "per": "serving forward, B=32",
                              **_sum(rec, 32, FUSED_SHAPES)}
        if name not in RESNET50_OFF_PATH:
            for key in step_sum:
                step_sum[key] += sums[key]
        lines.append(entry)
    print(json.dumps({"kernels": lines,
                      "training_step_kernels_sum": step_sum,
                      "batchnorm_step": {
                          name: records["batchnorm"][name]["step"]
                          for name, _, _ in BN_MODELS},
                      "training_step_part_sums_ms": device[PART_SUM_NAME],
                      "mining": mining_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [CHILD_FLAG]:
        _fit_child(sys.argv[2:])
    elif sys.argv[1:2] == [TP_CHILD_FLAG]:
        _tp_child(sys.argv[2:])
    elif sys.argv[1:2] == ["--batchnorm"]:
        check_card()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build()
        batchnorm_kernel_phase({})
    elif sys.argv[1:2] == ["--vit"]:
        attention_paths()
    elif sys.argv[1:2] == ["--attention"]:
        check_card()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build()
        attention_kernel_phase({})
    else:
        main()
