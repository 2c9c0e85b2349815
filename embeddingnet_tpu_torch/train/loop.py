"""The training loop: config + data -> trained embedding model (port of
``embeddingnet_tpu/train/loop.py`` ``Trainer``: the triplet, siamese and
arcface modes and the softmax pretraining).

One :class:`Trainer` drives the epochs of a run: batches decoded on host
threads (:class:`~embeddingnet_tpu_torch.data.pipeline.BatchLoader`, with
the decode cache) — P-K batches for triplet mode, pairs for siamese mode,
uniform batches for arcface mode —
copied to the device from pinned memory one batch ahead, the train step
(with its mining, in triplet mode); then the val epoch on offline triplets
or pairs (arcface mode has none and monitors the train loss), recall@1/@5
by kNN every ``TRAIN.eval_recall_every`` epochs,
the plateau scale, the best checkpoint and early stopping. With
``TRAIN.mining_warmup_epochs`` the first epochs mine with
``TRAIN.mining_warmup_mode`` and the step is rebuilt at the stage
boundary. It resumes a run from a checkpoint with the same parameters,
optimizer state, random state and callbacks as an uninterrupted one.
:meth:`Trainer.pretrain_softmax` runs the ``SOFTMAX_PRETRAINING`` phase
and hands its backbone to the encoder.

It runs on the device it is given (``cuda`` unless the caller asks for
``cpu``) and never falls back: not to the CPU when there is no card, nor
to cuDNN when a kernel of ``PERFORMANCE.pallas_conv`` fails. It builds
every backbone of the port's registry, and loads ``MODEL.backbone_weights``
(a local file, or a named preset in ``$EMBEDDINGNET_WEIGHTS_DIR``) into the
fresh module as the JAX Trainer does: the encoder's backbone and head keys
that the file holds, into the encoder of the siamese and arcface modules.
What the port lacks raises ``NotImplementedError`` at construction, before
anything is written, naming its ``ROADMAP.md`` item: a one-process mesh
over several cards (item 13).

Data parallelism: under an initialised ``torch.distributed`` process
group (``torchrun --nproc_per_node=N tools/train_torch.py``, one process
per card) each rank feeds its block of every global batch
(:class:`~embeddingnet_tpu_torch.data.samplers.ProcessShardSampler`) to
the data-parallel step (:mod:`~embeddingnet_tpu_torch.train.steps`), so
the ranks train one model bit for bit alike; the val epoch splits its
batches the same way, the recall eval searches the DB spread over the
ranks (:mod:`~embeddingnet_tpu_torch.parallel.sharded_knn`), the epoch's
metrics are rank 0's (broadcast, so the plateau, early-stop and
checkpoint decisions agree), rank 0 alone prints, logs and writes
checkpoints, and every rank loads them. ``PERFORMANCE.remat``
rematerialises the triplet and ArcFace steps' backbone blocks (the
siamese step warns and keeps its activations); ``params_dtype:
bfloat16`` keeps parameters, BatchNorm statistics and the optimizer state
in bf16; ``async_checkpoint`` writes checkpoints on a background thread.

Tensor parallelism (``MESH.model > 1``): the ranks form a ``(data,
model)`` grid (:func:`~embeddingnet_tpu_torch.parallel.mesh.build_grid`,
rank ``d * model + m``); the module is split over the model group by
:func:`~embeddingnet_tpu_torch.parallel.tp.shard_module` (a ViT's
attention and MLP, the ArcFace class weights, the softmax head's logits;
a CNN stays whole on every rank) before the optimizer is built; every
rank of a model group feeds the rows of its data index, the data group
takes the place of the world above, and the recall runs the split
encoder. Checkpoints hold whole tensors (gathered on save, sliced on
load), so a run resumes across layouts; :meth:`Trainer.encoder_variables`
returns whole tensors too, for the export that rank 0 writes.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from embeddingnet_tpu_torch.data.pipeline import BatchLoader, DecodeCache
from embeddingnet_tpu_torch.data.samplers import (PairSampler, PKSampler,
                                                  ProcessShardSampler,
                                                  SimpleSampler,
                                                  TripletSampler)
from embeddingnet_tpu_torch.models import pretrained
from embeddingnet_tpu_torch.models.registry import (ArcFaceModule,
                                                    EmbeddingModule,
                                                    SiameseModule,
                                                    SoftmaxModule,
                                                    backbone_param_mask,
                                                    list_backbones,
                                                    transfer_backbone_params)
from embeddingnet_tpu_torch.ops.augment import augment_from_params
from embeddingnet_tpu_torch.parallel import collectives, mesh
from embeddingnet_tpu_torch.parallel import tp as tensor_parallel
from embeddingnet_tpu_torch.parallel.collectives import (DataParallel,
                                                         ModelParallel)
from embeddingnet_tpu_torch.train import callbacks as cb
from embeddingnet_tpu_torch.train import checkpoint as ckpt
from embeddingnet_tpu_torch.train import optim, steps
from embeddingnet_tpu_torch.train.state import TrainState
from embeddingnet_tpu_torch.utils import trace
from embeddingnet_tpu_torch.utils.logging import MetricsLogger

# the modes whose module nests the encoder under ``encoder``
_NESTED = ("siamese", "arcface")


class Trainer:
    def __init__(self, params, data_loader, *, device="cuda",
                 log_fn: Callable = print):
        with trace.span("init"):
            self._construct(params, data_loader, device, log_fn)

    def _construct(self, params, data_loader, device, log_fn):
        self.params = params
        self.data_loader = data_loader
        self.mode = params.model.mode
        self.device = torch.device(device)
        # a process group makes this process one rank of a parallel run
        # (torchrun): a data row of the (data, model) grid, and a slice of
        # the model with MESH.model > 1; without one it trains alone
        self._distributed = (torch.distributed.is_available()
                             and torch.distributed.is_initialized())
        self._rank0 = mesh.world().rank == 0
        self.log = log_fn if self._rank0 else (lambda *a, **k: None)
        self._check_supported()
        self.grid, self.parallel, self.tp = None, None, None
        if self._distributed:
            self.grid = mesh.build_grid(params.mesh.data, params.mesh.model)
            self.parallel = DataParallel.current()
            self.tp = ModelParallel.current()
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"Trainer: device {device!r} asked for, "
                                   f"but CUDA is not available")
            if self.device.index is None:
                # the rank's card (torchrun's LOCAL_RANK, set by
                # parallel.mesh.maybe_initialize_distributed)
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            # f32 matmuls stay f32: the mining's distances cancel badly in
            # TF32 (as EmbeddingNet sets it)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.paths = ckpt.create_save_folders(params.general)
        perf = params.performance
        self.compute_dtype = (torch.bfloat16
                              if perf.compute_dtype == "bfloat16"
                              else torch.float32)
        if perf.remat and self.mode == "siamese":
            warnings.warn("PERFORMANCE.remat: the siamese step keeps its "
                          "activations", UserWarning, stacklevel=2)
        cache_mb = perf.decode_cache_mb
        self._decode_cache = DecodeCache(cache_mb) if cache_mb > 0 else None
        self.augment_fn = augment_from_params(params)
        self._build_module()
        if perf.params_dtype == "bfloat16":
            # bf16 master weights, as JAX casts its variables (parameters
            # and BatchNorm statistics) before the optimizer is built; the
            # optimizer state follows the parameters' dtype
            self.module.to(torch.bfloat16)
        self._build_optimizer()
        self._build_steps()
        if self.parallel is not None:
            collectives.check_replicated(self.module, self.parallel.group)

        self.history = cb.History()
        self.plateau = cb.ReduceLROnPlateau(
            monitor=self._monitor(), factor=params.train.plateau_factor,
            patience=params.train.plateau_patience)
        self.early_stop = cb.EarlyStopping(
            monitor=self._monitor(),
            patience=params.train.early_stopping_patience)
        self.ckpt_mgr = ckpt.CheckpointManager(
            self.paths["weights"], monitor=self._monitor(),
            mode=cb.monitor_mode(self._monitor()),
            async_save=perf.async_checkpoint, map_location=self.device,
            parallel=self.parallel)
        self.start_epoch = 0
        # per fitted epoch: wall seconds of the epoch and of its parts (the
        # train epoch's wait for batches among them), and the checkpoint's
        # bytes (0 when none was written)
        self.timings = []
        # the recall eval's decoded images, by tag: (paths, uint8 array)
        self._recall_decoded = {}
        self.metrics_logger = MetricsLogger(
            self.paths["tensorboard"],
            tensorboard=params.general.tensorboard_callback,
            wandb_enabled=params.general.wandb_callback) if self._rank0 \
            else None

    # -- construction ------------------------------------------------------

    def _check_supported(self):
        """Raise ``NotImplementedError`` for what the port cannot run yet,
        and resolve ``MODEL.backbone_weights`` (``FileNotFoundError`` for
        a preset with no file), before anything is built or written."""
        p = self.params
        if p.model.backbone_name not in list_backbones():
            raise ValueError(
                f"MODEL.backbone_name {p.model.backbone_name!r} is not a "
                f"backbone name; valid: {list_backbones()}")
        self._weights_path = pretrained.resolve_weights(
            p.model.backbone_weights, p.model.backbone_name)
        world, model = mesh.world().size, p.mesh.model
        if not self._distributed and (model > 1 or p.mesh.data
                                      not in (-1, 1)):
            ranks = (p.mesh.data if p.mesh.data > 0 else 1) * model
            raise NotImplementedError(
                f"MESH.data={p.mesh.data}, MESH.model={model} in one "
                f"process: the PyTorch port runs one process per card and "
                f"has no one-process mesh over several cards (see "
                f"ROADMAP.md, item 13); launch {ranks} ranks with torchrun "
                f"--nproc_per_node={ranks} (--dist_backend gloo for ranks "
                f"that share a card), or set MESH.data: -1, MESH.model: 1")
        if model < 1 or world % model:
            raise ValueError(f"MESH.model={model} on a world of {world} "
                             f"ranks: it must divide the world")
        data = world // model
        if p.mesh.data not in (-1, data):
            if p.mesh.data == 1:
                raise ValueError(
                    "a multi-process launch needs a data axis over every "
                    "rank of a model slot: set MESH.data: -1 (all ranks)")
            raise ValueError(f"MESH.data={p.mesh.data} with MESH.model="
                             f"{model} on a world of {world} ranks: set "
                             f"MESH.data: -1 or {data}")
        g = p.generator
        batch = g.k_classes * g.k_samples if self.mode == "triplet" \
            else g.batch_size
        if data > 1 and batch % data:
            raise ValueError(f"global batch {batch} must divide by the "
                             f"data axis' {data} ranks")

    def _monitor(self) -> str:
        # TRAIN.monitor overrides; else val_loss when validating, else
        # loss; arcface mode has no val epoch, so loss
        if self.params.train.monitor:
            return self.params.train.monitor
        if self.mode == "arcface":
            return "loss"
        return "val_loss" if self.data_loader.validate else "loss"

    def _build_module(self):
        m = self.params.model
        if self.mode == "siamese":
            # the JAX SiameseModule hands its encoder no bn_momentum, so the
            # siamese encoder keeps the default 0.99 whatever
            # PERFORMANCE.bn_momentum says (as the JAX Trainer runs it)
            self.module = SiameseModule(
                backbone_name=m.backbone_name,
                encodings_len=m.encodings_len,
                embeddings_normalization=m.embeddings_normalization,
                distance_type=m.distance_type,
                fast_conv=self.params.performance.pallas_conv,
                dtype=self.compute_dtype, input_shape=m.input_shape)
        elif self.mode == "arcface":
            # the encoder trains without the normalisation (the loss
            # normalises); recall and export add it (_new_encoder)
            self.module = ArcFaceModule(
                backbone_name=m.backbone_name,
                encodings_len=m.encodings_len,
                n_classes=self.data_loader.n_classes,
                embeddings_normalization=False,
                fast_conv=self.params.performance.pallas_conv,
                dtype=self.compute_dtype, input_shape=m.input_shape)
        else:
            self.module = self._new_encoder()
        self.module.reset_parameters(
            torch.Generator().manual_seed(self.params.general.seed))
        self.module.to(self.device)
        if self._weights_path is not None:
            # the file's keys are a standalone encoder's, which the siamese
            # and arcface modules nest under ``encoder``; loaded before any
            # bf16 cast of the master weights, as JAX casts after loading
            pretrained.load_into(self.encoder, self._weights_path)
            self.log(f"loaded backbone weights from {self._weights_path}")
        # this rank's slices of the split parameters (a no-op without a
        # model axis, and on a CNN)
        tensor_parallel.shard_module(self.module, self.tp)
        self._view = None

    def _new_encoder(self) -> EmbeddingModule:
        """An encoder of the config's architecture (the triplet model, or
        the eval/export view of the siamese or arcface one, without the
        classifier their trees lack). The arcface view L2-normalises, as
        the JAX ``encoder_module`` does: the mode trains cosine structure
        only, so retrieval lives on the hypersphere."""
        m = self.params.model
        return EmbeddingModule(
            backbone_name=m.backbone_name, encodings_len=m.encodings_len,
            embeddings_normalization=(m.embeddings_normalization
                                      or self.mode == "arcface"),
            bn_momentum=self.params.performance.bn_momentum,
            fast_conv=self.params.performance.pallas_conv,
            dtype=self.compute_dtype, classifier=self.mode == "triplet",
            input_shape=m.input_shape)

    @property
    def encoder(self) -> EmbeddingModule:
        """The live encoder: the module, or the siamese or arcface
        module's."""
        return self.module.encoder if self.mode in _NESTED else self.module

    def _build_optimizer(self):
        t = self.params.train
        schedule = optim.step_decay_schedule(
            t.learning_rate, t.decay_factor, t.step_size,
            self.params.generator.n_batches, warmup_epochs=t.warmup_epochs)
        opt_kwargs = ({"weight_decay": t.weight_decay}
                      if t.optimizer == "adamw" else {})
        self.optimizer = optim.get_optimizer(t.optimizer, schedule,
                                             **opt_kwargs)
        freeze = self.params.model.freeze_backbone
        trainable = backbone_param_mask(self.module, freeze) if freeze \
            else None
        generator = torch.Generator(device=self.device).manual_seed(
            self.params.general.seed + 1)
        self.state = TrainState.create(
            self.module, self.optimizer, generator=generator,
            trainable=trainable,
            ema_decay=self.params.performance.ema_decay)

    def _mining_mode_for_epoch(self, epoch: int) -> str:
        """The negatives-selection mode of an epoch: in triplet mode the
        first ``TRAIN.mining_warmup_epochs`` run ``TRAIN.mining_warmup_mode``;
        a pure function of the epoch, so a resumed run lands in the right
        stage."""
        t = self.params.train
        if self.mode == "triplet" and epoch < t.mining_warmup_epochs:
            return t.mining_warmup_mode
        return self.params.generator.negatives_selection_mode

    def _build_steps(self, mining_mode: Optional[str] = None):
        g = self.params.generator
        reg_rules = optim.reg_rules_for(self.params.model.backbone_name)
        self._mining_mode = mining_mode or self._mining_mode_for_epoch(0)
        if self.mode == "siamese":
            self.train_step = steps.make_siamese_train_step(
                self.module, self.optimizer,
                augment_fn=self.augment_fn, reg_rules=reg_rules,
                compute_dtype=self.compute_dtype, parallel=self.parallel)
            self.eval_step = steps.make_siamese_eval_step(
                self.module, compute_dtype=self.compute_dtype)
            return
        if self.mode == "arcface":
            self.train_step = steps.make_arcface_train_step(
                self.module, self.optimizer,
                n_classes=self.data_loader.n_classes, margin=g.margin,
                augment_fn=self.augment_fn, compute_dtype=self.compute_dtype,
                remat=self.params.performance.remat, parallel=self.parallel)
            self.eval_step = None
            return
        self.train_step = steps.make_triplet_train_step(
            self.module, self.optimizer, margin=g.margin,
            mode=self._mining_mode, augment_fn=self.augment_fn,
            reg_rules=reg_rules, compute_dtype=self.compute_dtype,
            # P-K batches bound the positives per anchor, which arms the
            # grouped paths; _check_pk_layout guards the layout.
            # k_samples=1 has no positives: claim nothing
            max_positives=g.k_samples - 1 if g.k_samples >= 2 else None,
            remat=self.params.performance.remat, parallel=self.parallel)
        self.eval_step = steps.make_triplet_eval_step(
            self.module, margin=g.margin, compute_dtype=self.compute_dtype)

    # -- data --------------------------------------------------------------

    def _train_loader(self):
        g = self.params.generator
        # a fresh sampler per epoch, seeded by the epoch: epochs differ, a
        # run is reproducible, and a resumed run draws what an
        # uninterrupted one would
        seed = (self.params.general.seed
                + 9973 * getattr(self, "_current_epoch", 0))
        if self.mode == "siamese":
            sampler = PairSampler(self.data_loader.train_data,
                                  self.data_loader.class_names,
                                  batch_size=g.batch_size, seed=seed)
        elif self.mode == "arcface":
            sampler = SimpleSampler(self.data_loader.train_data,
                                    self.data_loader.class_names,
                                    batch_size=g.batch_size, seed=seed)
        else:
            sampler = PKSampler(self.data_loader.train_data,
                                self.data_loader.class_names,
                                k_classes=g.k_classes,
                                k_samples=g.k_samples, seed=seed)
        sampler = self._wrap_process_shard(sampler, pk_check=True)
        return BatchLoader(sampler, self.params.model.input_shape,
                           n_batches=g.n_batches,
                           fast_decode=self.params.performance.fast_decode,
                           cache=self._decode_cache)

    def _val_loader(self):
        if self.mode == "arcface":
            return None
        if not self.data_loader.validate or not self.data_loader.val_data:
            return None
        g = self.params.generator
        seed = self.params.general.seed + 1000
        if self.mode == "siamese":
            sampler = PairSampler(self.data_loader.val_data,
                                  self.data_loader.class_names,
                                  batch_size=g.batch_size, seed=seed)
        else:
            # offline random triplets, as the reference validates triplet
            # mode
            sampler = TripletSampler(self.data_loader.val_data,
                                     self.data_loader.class_names,
                                     batch_size=g.batch_size, seed=seed)
        sampler = self._wrap_process_shard(sampler)
        return BatchLoader(sampler, self.params.model.input_shape,
                           n_batches=g.n_batches_val,
                           cache=self._decode_cache)

    def _wrap_process_shard(self, sampler, pk_check: bool = False):
        """Under several ranks every rank draws the identical global batch
        (same seeds) and keeps its block of rows; the P-K layout guard then
        runs here, on the global labels (the miner asserts the global
        layout). One process: the sampler as it is."""
        if self.parallel is None:
            return sampler
        lo, hi = self.parallel.rows(sampler.batch_size)
        check = (self._validate_pk_labels
                 if pk_check and self._pk_armed() else None)
        return ProcessShardSampler(sampler, lo, hi, global_check=check)

    # -- resume ------------------------------------------------------------

    def restore_best(self) -> bool:
        """Load the best-monitored checkpoint into the live state (the
        manager keeps best-only saves, so its latest epoch is the best).
        Returns False when nothing was saved."""
        if self.ckpt_mgr.latest_epoch() is None:
            return False
        _, host = self.ckpt_mgr.restore(self.state, None)
        self.log(f"restored best checkpoint (epoch {host.get('epoch')}, "
                 f"{self.ckpt_mgr.monitor}={host.get('best')})")
        return True

    def resume(self, epoch: Optional[int] = None):
        """Restore the train state and the callbacks' state from a
        checkpoint (``None``: the latest); the next :meth:`fit` starts at
        the epoch after it. ``FileNotFoundError`` when there is none."""
        _, host = self.ckpt_mgr.restore(self.state, epoch)
        self.start_epoch = int(host.get("epoch", 0)) + 1
        if "plateau" in host:
            self.plateau.load_state_dict(host["plateau"])
        if "early_stop" in host:
            self.early_stop.load_state_dict(host["early_stop"])
        self.log(f"resumed from epoch {self.start_epoch - 1}")
        return self

    # -- epochs ------------------------------------------------------------

    def _to_device(self, x):
        """A host batch (array or tuple of arrays) on the device, by a
        non-blocking copy from pinned memory on a card; ``(device batch,
        host tensors)``: the host tensors must outlive the copy."""
        if isinstance(x, tuple):
            pairs = [self._to_device(a) for a in x]
            return (tuple(d for d, _ in pairs),
                    tuple(h for _, h in pairs))
        host = torch.from_numpy(np.asarray(x))
        if self.device.type == "cuda":
            with trace.span("data.pin"):
                host = host.pin_memory()
        return host.to(self.device, non_blocking=True), host

    def _device_prefetch(self, loader):
        """Double-buffered host-to-device copy: batch N+1's copy is enqueued
        before step N is handed out, from a pinned buffer of its own that
        is kept until its step is done. ``PERFORMANCE.device_prefetch:
        false`` copies each batch when it is taken (a debug aid)."""
        if not self.params.performance.device_prefetch:
            for images, labels in loader:
                yield self._to_device(images)[0], self._to_device(labels)[0]
            return
        prev = None
        for images, labels in loader:
            cur = (self._to_device(images), self._to_device(labels))
            if prev is not None:
                yield prev[0][0], prev[1][0]
            prev = cur
        if prev is not None:
            yield prev[0][0], prev[1][0]

    def _check_pk_layout(self, loader):
        """Host-side guard of the grouped P-K layout that the armed miner
        asserts, on every batch (O(B) on the host-side labels)."""
        # under several ranks ProcessShardSampler checks the global labels
        armed = self._pk_armed() and self.parallel is None
        for batch in loader:
            if armed:
                self._validate_pk_labels(batch[1])
            yield batch

    def _pk_armed(self) -> bool:
        # the parity modes and batch_all poison a broken layout when
        # k_samples is armed; batch_hard takes any layout
        return (self.mode == "triplet"
                and self.params.generator.k_samples >= 2
                and self._mining_mode != "batch_hard")

    def _validate_pk_labels(self, labels):
        k = self.params.generator.k_samples
        labels = np.asarray(labels)
        b = labels.shape[0]
        if not (1 < k < b and b % k == 0):
            return
        blocks = labels.reshape(b // k, k)
        grouped = bool(np.all(blocks == blocks[:, :1]))
        heads = blocks[:, 0]
        distinct = len(np.unique(heads)) == heads.shape[0]
        if not (grouped and distinct):
            raise ValueError(
                "triplet train batch is not grouped P-K: with "
                f"GENERATOR.k_samples={k} the miner asserts "
                "contiguous groups of k_samples same-class "
                "images with no class split across groups "
                "(PKSampler produces this). A custom loader "
                "must either honor that layout or unset "
                "k_samples (slower dense mining).")

    @staticmethod
    def _accumulate(totals, metrics):
        """Metrics summed on the device: no host round trip per step."""
        if totals is None:
            return dict(metrics)
        return {k: totals[k] + v for k, v in metrics.items()}

    def _run_train_epoch(self) -> dict:
        totals, count, images_seen = None, 0, 0
        t0 = time.perf_counter()
        batches = self._device_prefetch(
            self._check_pk_layout(self._train_loader()))
        # host seconds spent waiting for the next batch (decode, pinning,
        # the copy's launch): the loader's share of the epoch
        self._data_wait_s = 0.0
        while True:
            t_wait = time.perf_counter()
            with trace.span("data.wait"):
                batch = next(batches, None)
            self._data_wait_s += time.perf_counter() - t_wait
            if batch is None:
                break
            images, targets = batch
            if self.mode == "siamese":
                args = (*images, targets)
                images_seen += sum(int(x.shape[0]) for x in images)
            else:
                args = (images, targets)
                images_seen += int(images.shape[0])
            with trace.span("step"):
                self.state, metrics = self.train_step(self.state, *args)
            totals = self._accumulate(totals, metrics)
            count += 1
            # a read every 32 steps keeps the queue of launches shallow
            if count % 32 == 0 or self.params.performance.debug_nans:
                self._check_finite(float(totals["loss"]))
        out = {k: float(v) / max(count, 1) for k, v in (totals or {}).items()}
        # the read above waited for the last step
        elapsed = time.perf_counter() - t0
        if self.parallel is not None:
            images_seen *= self.parallel.size   # the global batches'
        out["images_per_sec"] = images_seen / max(elapsed, 1e-9)
        return out

    def _check_finite(self, loss_sum: float):
        if self.params.performance.debug_nans and not np.isfinite(loss_sum):
            raise FloatingPointError(
                f"PERFORMANCE.debug_nans: the train loss is {loss_sum}")

    def _run_val_epoch(self) -> dict:
        loader = self._val_loader()
        if loader is None:
            return {}
        totals, count = None, 0
        for images, targets in self._device_prefetch(loader):
            # siamese: (pair streams) and targets; triplet: (a, p, n)
            args = (*images, targets) if self.mode == "siamese" else images
            totals = self._accumulate(totals,
                                      self.eval_step(self.state, *args))
            count += 1
            if count % 32 == 0:
                float(totals["loss"])
        if totals is not None and self.parallel is not None:
            # each rank's mean over its equal block of every batch: the
            # global mean is their mean
            totals = {k: v / self.parallel.size
                      for k, v in steps._global(self.parallel,
                                                totals).items()}
        return {f"val_{k}": float(v) / max(count, 1)
                for k, v in (totals or {}).items()}

    def fit(self, n_epochs: Optional[int] = None) -> cb.History:
        n_epochs = n_epochs or self.params.train.n_epochs
        profile_dir = os.environ.get("EMBEDDINGNET_PROFILE")
        for epoch in range(self.start_epoch, n_epochs):
            t_epoch = time.perf_counter()
            self._current_epoch = epoch   # epoch-distinct sampler seeds
            want_mode = self._mining_mode_for_epoch(epoch)
            if want_mode != self._mining_mode:
                # staged mining: a new step for the new selection mode; the
                # module, optimizer and generator carry over untouched
                self.log(f"epoch {epoch}: mining mode {self._mining_mode} "
                         f"-> {want_mode} (TRAIN.mining_warmup_epochs="
                         f"{self.params.train.mining_warmup_epochs})")
                self._build_steps(mining_mode=want_mode)
            if profile_dir and epoch == self.start_epoch:
                # a torch.profiler trace of the first epoch (Perfetto or
                # chrome://tracing)
                with self._profiler() as prof:
                    train_metrics = self._run_train_epoch()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    profile_dir, f"epoch{epoch}_trace.json"))
            else:
                train_metrics = self._run_train_epoch()
            t_val = time.perf_counter()
            val_metrics = self._run_val_epoch()
            t_recall = time.perf_counter()
            every = self.params.train.eval_recall_every
            if every and (epoch + 1) % every == 0:
                rec = self.evaluate_recall()
                if rec:
                    # cold evals decode, warm ones only encode
                    rec["recall_eval_s"] = time.perf_counter() - t_recall
                val_metrics.update(rec)
            t_ckpt = time.perf_counter()
            metrics = self._agreed({**train_metrics, **val_metrics})
            self.history.append(metrics)
            if self.metrics_logger is not None:
                self.metrics_logger.log(epoch, metrics)

            self.state.plateau_scale = self.plateau.update(metrics)
            # the early stop's decision is made before the save, so that a
            # resumed run carries this epoch's update of its state
            stop = self.early_stop.update(metrics)
            saved = self.ckpt_mgr.save(
                epoch, self.state, metrics,
                host_state={"plateau": self.plateau.state_dict(),
                            "early_stop": self.early_stop.state_dict()})
            t_end = time.perf_counter()
            self.timings.append({
                "epoch": epoch, "epoch_s": t_end - t_epoch,
                "train_s": t_val - t_epoch,
                "data_wait_s": self._data_wait_s, "val_s": t_recall - t_val,
                "recall_s": t_ckpt - t_recall, "checkpoint_s": t_end - t_ckpt,
                "checkpoint_bytes": self._checkpoint_bytes(epoch)
                if saved and self._rank0 and not self.ckpt_mgr.async_save
                else saved and self._rank0})
            self.log(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            if stop:
                break
        # an async save may still be running: its size once written (0 for
        # a checkpoint that max_to_keep has removed since)
        self.ckpt_mgr.wait()
        for t in self.timings:
            if isinstance(t["checkpoint_bytes"], bool):
                t["checkpoint_bytes"] = (
                    self._checkpoint_bytes(t["epoch"])
                    if t["checkpoint_bytes"] and os.path.isdir(os.path.join(
                        self.ckpt_mgr.directory, str(t["epoch"]))) else 0)
        return self.history

    def _agreed(self, metrics: dict) -> dict:
        """The epoch's metrics as every rank uses them: rank 0's, broadcast
        (the train and val metrics are global already; the host timings
        differ by rank), so that no rank decides alone."""
        if self.parallel is None:
            return metrics
        box = [metrics]
        # over every rank: the model groups' ranks decide alike too
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _checkpoint_bytes(self, epoch: int) -> int:
        path = os.path.join(self.ckpt_mgr.directory, str(epoch))
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    # -- recall ------------------------------------------------------------

    def evaluate_recall(self) -> dict:
        """recall@1/@5: encode a capped train DB and every val image with
        the encoder (:meth:`encoder_variables`: EMA weights when
        ``PERFORMANCE.ema_decay`` is on) in 256-image chunks, kNN on the
        device. The decoded images are cached across evals
        (``PERFORMANCE.eval_decode_cache_mb``): the path lists are fixed,
        only the weights change."""
        from embeddingnet_tpu_torch.data.images import get_images
        from embeddingnet_tpu_torch.ops import knn as knn_ops

        dl = self.data_loader
        if not dl.val_data:
            return {}
        cap = self.params.train.eval_recall_max_per_class
        encoder = self._recall_encoder()

        def decoded(paths, tag):
            """The decoded uint8 images of ``paths``, cached when complete
            (no dropped files, which would misalign the labels) and under
            the configured cap."""
            cap_mb = self.params.performance.eval_decode_cache_mb
            cache = self._recall_decoded
            hit = cache.get(tag)
            if hit is not None and hit[0] == paths:
                return hit[1]
            imgs = get_images(paths, self.params.model.input_shape)
            if (cap_mb > 0 and imgs.shape[0] == len(paths)
                    and imgs.nbytes <= cap_mb * 1e6):
                cache[tag] = (list(paths), imgs)
            return imgs

        @torch.no_grad()
        def encode_paths(paths, tag):
            all_imgs = decoded(paths, tag)
            out = []
            for s in range(0, len(all_imgs), 256):
                imgs = torch.from_numpy(all_imgs[s:s + 256])
                # f32 /255, as the JAX package feeds its recall encoder
                x = imgs.to(self.device).float() / 255.0
                out.append(encoder(x).float())
            return torch.cat(out) if out else None

        db_paths, db_labels = [], []
        for cls, ps in dl.train_data.items():
            ps = list(ps)[:cap]
            db_paths.extend(ps)
            db_labels.extend([cls] * len(ps))
        val_paths, val_labels = dl.flat("val")
        classes = sorted({*db_labels, *val_labels})
        cid = {c: i for i, c in enumerate(classes)}

        q_emb = encode_paths(val_paths, "val")
        k5 = min(5, len(db_labels))
        db_ids = torch.as_tensor([cid[l] for l in db_labels],
                                 device=self.device)
        if self.parallel is not None:
            if q_emb is None or not db_paths:
                return {}
            idx5 = self._sharded_neighbors(encode_paths, db_paths, q_emb,
                                           db_ids, k5, len(classes))
            pred = db_ids[idx5[:, 0]]      # the nearest neighbour: top-1
            pred, idx5 = pred.tolist(), idx5.tolist()
        else:
            db_emb = encode_paths(db_paths, "db")
            if db_emb is None or q_emb is None:
                return {}
            pred, _ = knn_ops.knn_classify(db_emb, db_ids, q_emb, k=1,
                                           n_classes=len(classes))
            _, idx5 = knn_ops.knn_neighbors(db_emb, q_emb, k=k5)
            pred, idx5 = pred.tolist(), idx5.tolist()
        top1 = np.mean([classes[pred[i]] == val_labels[i]
                        for i in range(len(val_labels))])
        top5 = np.mean([val_labels[i] in {db_labels[j] for j in idx5[i]}
                        for i in range(len(val_labels))])
        return {"val_recall1": float(top1), "val_recall5": float(top5)}

    def _sharded_neighbors(self, encode_paths, db_paths, q_emb, db_ids, k,
                           n_classes):
        """The recall's k nearest DB rows by the sharded kNN: the DB padded
        to a multiple of the world with far rows labelled -1 (which never
        reach the top-k of a DB of k real rows or more), each rank encoding
        its block of it; every rank encodes the queries."""
        from embeddingnet_tpu_torch.parallel.sharded_knn import sharded_knn
        dp = self.parallel
        n = len(db_paths)
        lo, hi = dp.rows(n + (-n) % dp.size)
        own = (encode_paths(db_paths[lo:min(hi, n)], f"db{dp.rank}")
               if lo < n else None)
        dim = q_emb.shape[1]
        far = torch.full((max(0, hi - max(lo, n)), dim), 1e6,
                         device=self.device)
        db_local = far if own is None else torch.cat([own, far])
        labels = torch.cat([db_ids, torch.full(((-n) % dp.size,), -1,
                                               dtype=db_ids.dtype,
                                               device=self.device)])
        _, _, idx = sharded_knn(dp, k=k, n_classes=n_classes)(
            db_local, labels[lo:hi], q_emb)
        return idx

    def _recall_encoder(self) -> torch.nn.Module:
        """The encoder in eval mode with :meth:`encoder_variables`: the live
        one, or (with EMA, or in arcface mode, whose view normalises) a
        second module from :meth:`_new_encoder` holding them."""
        if self.state.ema is None and self.mode != "arcface":
            return self.encoder.eval()
        if self._view is None:
            self._view = tensor_parallel.shard_module(
                self._new_encoder().to(self.device), self.tp)
        self._view.load_state_dict(self._local_encoder_variables())
        return self._view.eval()

    # -- export ------------------------------------------------------------

    def encoder_variables(self) -> dict:
        """The encoder's ``state_dict`` for export (in siamese and arcface
        mode the module's encoder, without the distance head or the class
        weights): the EMA parameters when ``PERFORMANCE.ema_decay`` is on,
        with the live BatchNorm statistics; else the live encoder's. Whole
        tensors: under a model axis every rank of the model group must call
        it (the slices are gathered)."""
        out = self._local_encoder_variables()
        prefix = "encoder." if self.mode in _NESTED else ""
        shards = {name[len(prefix):]: split for name, split in
                  (getattr(self.module, "tp_shards", None) or {}).items()
                  if name.startswith(prefix)}
        return {k: collectives.gather_slices(v, *shards[k], self.tp)
                if k in shards else v for k, v in out.items()}

    def _local_encoder_variables(self) -> dict:
        """:meth:`encoder_variables` as this rank holds them (its slices
        under a model axis)."""
        out = dict(self.encoder.state_dict())
        if self.state.ema is not None:
            prefix = "encoder." if self.mode in _NESTED else ""
            out.update({name[len(prefix):]: value
                        for name, value in self.state.ema.items()
                        if name.startswith(prefix)})
        return out

    # -- softmax pretraining -----------------------------------------------

    def pretrain_softmax(self) -> Optional[TrainState]:
        """The ``SOFTMAX_PRETRAINING`` phase (the JAX
        ``Trainer.pretrain_softmax``): a :class:`SoftmaxModule` whose
        backbone starts with the encoder's parameters (its BatchNorm
        statistics fresh, as in JAX) trains with the section's
        optimizer and step-decay schedule on :class:`SimpleSampler` batches
        (seeds ``GENERAL.seed`` + 11, and + 12 for the val batches), under
        a plateau scale (patience 4) and an early stop (patience 10) on
        ``val_loss`` (``loss`` without val batches); the best epoch's
        weights are kept, saved to ``pretraining_weights/backbone.pt`` and
        the backbone handed to the encoder. The main optimizer's moments
        and the EMA keep their start, as in JAX. Returns the pretraining's
        state, or None without the section."""
        sp = self.params.softmax
        if sp is None:
            return None
        m, seed = self.params.model, self.params.general.seed
        dl = self.data_loader
        module = SoftmaxModule(m.backbone_name, n_classes=dl.n_classes,
                               dtype=self.compute_dtype,
                               input_shape=m.input_shape)
        module.reset_parameters(torch.Generator().manual_seed(seed + 7))
        module.to(self.device)
        # split as the encoder is, so that the backbones' slices meet
        tensor_parallel.shard_module(module, self.tp)
        transfer_backbone_params(self.encoder, module)
        optimizer = optim.get_optimizer(sp.optimizer, optim.step_decay_schedule(
            sp.learning_rate, sp.decay_factor, sp.step_size,
            sp.steps_per_epoch))
        state = TrainState.create(
            module, optimizer, generator=torch.Generator(
                device=self.device).manual_seed(seed + 7))
        train_step = steps.make_softmax_train_step(
            module, optimizer, n_classes=dl.n_classes,
            augment_fn=self.augment_fn, compute_dtype=self.compute_dtype)
        eval_step = steps.make_softmax_eval_step(
            module, n_classes=dl.n_classes, compute_dtype=self.compute_dtype)
        sampler = SimpleSampler(dl.train_data, dl.class_names,
                                batch_size=sp.batch_size, seed=seed + 11)
        validate = bool(dl.validate and dl.val_data and sp.val_steps > 0)
        val_sampler = SimpleSampler(
            dl.val_data, dl.class_names, batch_size=sp.batch_size,
            seed=seed + 12) if validate else None
        monitor = "val_loss" if validate else "loss"
        plateau = cb.ReduceLROnPlateau(monitor=monitor, patience=4)
        early = cb.EarlyStopping(monitor=monitor, patience=10)
        best_value, best = float("inf"), None
        for epoch in range(sp.n_epochs):
            state, metrics = self._pretrain_epoch(
                state, train_step, eval_step, sampler, val_sampler, sp)
            if metrics.get(monitor, float("inf")) < best_value:
                best_value = metrics[monitor]
                best = {k: v.detach().clone()
                        for k, v in module.state_dict().items()}
            state.plateau_scale = plateau.update(metrics)
            self.log(f"softmax-pretrain epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            if early.update(metrics):
                break
        if best is not None:
            module.load_state_dict(best)
        whole = tensor_parallel.gather_module_state(module)
        if self._rank0:
            torch.save({k: v.cpu() for k, v in whole.items()},
                       os.path.join(self.paths["pretraining_weights"],
                                    "backbone.pt"))
        if self.parallel is not None:
            # every rank ran the whole pretraining; rank 0's result is the
            # one all keep (the card's kernels need not agree bit for bit)
            collectives.broadcast_module(module, self.parallel.group)
        self._finish_pretrain(module)
        return state

    def _pretrain_epoch(self, state, train_step, eval_step, sampler,
                        val_sampler, sp):
        """One pretraining epoch: ``sp.steps_per_epoch`` train steps, then
        ``sp.val_steps`` val batches when ``val_sampler`` is given; returns
        ``(state, metrics)``, the metrics averaged over the batches."""
        shape = self.params.model.input_shape
        totals, count = None, 0
        loader = BatchLoader(sampler, shape, n_batches=sp.steps_per_epoch)
        for images, labels in self._device_prefetch(loader):
            state, metrics = train_step(state, images, labels)
            totals = self._accumulate(totals, metrics)
            count += 1
        out = {k: float(v) / max(count, 1) for k, v in (totals or {}).items()}
        if val_sampler is not None:
            totals, count = None, 0
            loader = BatchLoader(val_sampler, shape, n_batches=sp.val_steps)
            for images, labels in self._device_prefetch(loader):
                totals = self._accumulate(totals,
                                          eval_step(state, images, labels))
                count += 1
            out.update({f"val_{k}": float(v) / max(count, 1)
                        for k, v in (totals or {}).items()})
        return state, out

    def _finish_pretrain(self, module: SoftmaxModule) -> None:
        """Hand the pretrained backbone (parameters and BatchNorm
        statistics) to the encoder."""
        transfer_backbone_params(module, self.encoder, statistics=True)
        where = "encoder.backbone" if self.mode in _NESTED else "backbone"
        self.log(f"softmax pretraining: the pretrained backbone "
                 f"({len(module.backbone.state_dict())} tensors) handed to "
                 f"the model's {where}")
