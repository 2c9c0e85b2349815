"""Config system: YAML experiment files -> typed, validated parameter trees
(the port's own copy of ``embeddingnet_tpu/config.py``, so that the port
imports nothing of the JAX package; PyYAML is imported inside
:func:`parse_params`, since a machine that runs only the port may lack it).
The two copies must parse every config alike;
``tests/test_torch_port_imports.py`` holds them together.

Keeps the reference's YAML schema (sections ``MODEL / DATALOADER / GENERATOR /
TRAIN / ENCODINGS / GENERAL [/ SOFTMAX_PRETRAINING]``, cf.
``embedding_net/utils.py:156-197`` and ``configs/road_signs_apollo.yml``) and
extends it with optional TPU-specific sections ``MESH`` and ``PERFORMANCE``.

Deliberate fixes over the reference (documented, not reproduced):

* the reference gates augmentations on the key ``augmentations_type`` but then
  reads ``augmentation_type`` (``embedding_net/utils.py:160-161``), so presets
  silently never load; here the ``GENERATOR.augmentations`` name (which the
  shipped configs actually use, ``configs/road_signs_apollo.yml:27``) selects
  the preset directly, with ``augmentation_type`` accepted as an alias.
* optimizer/augmentation *objects* are not baked into the params dict; the
  params stay plain data and factories are invoked where needed (functional
  JAX style — an optax optimizer is not a mutable object to share).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence


class ConfigError(ValueError):
    """Raised when an experiment config fails validation."""


class _SectionBase:
    """Mapping-style access so call sites can use ``params['key']`` or attrs.

    The reference passes param dicts around with ``**kwargs`` splats
    (``tools/train.py:110-117``); supporting the mapping protocol keeps that
    public surface intact while giving us typed attributes internally.
    """

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def keys(self):
        return [f.name for f in dataclasses.fields(self)]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_VALID_MODES = ("triplet", "siamese", "arcface")
_VALID_DISTANCES = ("l1", "l2")
_VALID_MINING = ("semihard", "hardest", "random_hard", "batch_all", "batch_hard")
_VALID_OPTIMIZERS = ("adam", "rms_prop", "radam", "sgd", "adamw")
_VALID_DTYPES = ("float32", "bfloat16")


@dataclass
class ModelConfig(_SectionBase):
    """``MODEL:`` section (cf. ``configs/road_signs_apollo.yml:1-9``)."""

    input_shape: Sequence[int] = (48, 48, 3)
    encodings_len: int = 256
    mode: str = "triplet"
    distance_type: str = "l1"
    backbone_name: str = "simple"
    # Named presets ('imagenet'/'noisy-student') resolve through
    # $EMBEDDINGNET_WEIGHTS_DIR at model build, or fail loudly — see
    # models/pretrained.resolve_weights (zero-egress stand-in for the
    # reference's download at backbones.py:96-104).
    backbone_weights: Optional[str] = "imagenet"
    # False | True ('all': freeze the whole backbone) | 'except_last_2'
    # (reference granularity, backbones.py:106-108).
    freeze_backbone: object = False
    embeddings_normalization: bool = True

    def __post_init__(self):
        if self.freeze_backbone not in (True, False, None, "all",
                                        "except_last_2"):
            raise ConfigError(
                "MODEL.freeze_backbone must be a bool, 'all', or "
                f"'except_last_2'; got {self.freeze_backbone!r}")
        self.input_shape = tuple(int(x) for x in self.input_shape)
        if len(self.input_shape) != 3:
            raise ConfigError(
                f"MODEL.input_shape must be [H, W, C], got {self.input_shape}")
        if self.mode not in _VALID_MODES:
            raise ConfigError(
                f"MODEL.mode must be one of {_VALID_MODES}, got {self.mode!r}")
        if self.distance_type not in _VALID_DISTANCES:
            raise ConfigError(
                f"MODEL.distance_type must be one of {_VALID_DISTANCES}, "
                f"got {self.distance_type!r}")
        if self.encodings_len <= 0:
            raise ConfigError("MODEL.encodings_len must be positive")


@dataclass
class DataLoaderConfig(_SectionBase):
    """``DATALOADER:`` section (cf. ``configs/road_signs_apollo.yml:11-18``).

    ``csv_file`` (used by ``configs/template.yml:13``) is accepted as an
    alias for ``train_csv_file``.
    """

    dataset_path: str = ""
    train_csv_file: Optional[str] = None
    val_csv_file: Optional[str] = None
    image_id_column: str = "image_id"
    label_column: str = "label"
    validate: bool = True
    val_ratio: float = 0.1
    is_google: bool = False
    cache_index: bool = True

    def __post_init__(self):
        if not (0.0 < self.val_ratio < 1.0):
            raise ConfigError("DATALOADER.val_ratio must be in (0, 1)")


@dataclass
class GeneratorConfig(_SectionBase):
    """``GENERATOR:`` section (cf. ``configs/road_signs_apollo.yml:20-27``)."""

    negatives_selection_mode: str = "semihard"
    k_classes: int = 5
    k_samples: int = 5
    margin: float = 0.5
    batch_size: int = 32
    n_batches: int = 10
    n_batches_val: int = 10
    augmentations: Optional[str] = None
    input_shape: Optional[Sequence[int]] = None  # injected from MODEL

    def __post_init__(self):
        if self.augmentations in ("none", "None", ""):
            self.augmentations = None
        if self.negatives_selection_mode not in _VALID_MINING:
            raise ConfigError(
                f"GENERATOR.negatives_selection_mode must be one of "
                f"{_VALID_MINING}, got {self.negatives_selection_mode!r}")
        if self.k_classes < 2:
            raise ConfigError("GENERATOR.k_classes must be >= 2 for mining")
        if self.k_samples < 2:
            raise ConfigError("GENERATOR.k_samples must be >= 2 for mining")


@dataclass
class TrainConfig(_SectionBase):
    """``TRAIN:`` section (cf. ``configs/road_signs_apollo.yml:29-40``)."""

    optimizer: str = "adam"
    learning_rate: float = 1e-3
    decay_factor: float = 0.99
    step_size: int = 1
    n_epochs: int = 10
    plot_history: bool = True
    # Host-loop callback knobs; reference hard-codes these in
    # ``tools/train.py:79-91``. Exposed so they are tunable.
    plateau_factor: float = 0.1
    plateau_patience: int = 4
    early_stopping_patience: int = 10
    # Retrieval validation: every N epochs encode a capped DB + the val
    # queries and log recall@1/@5 (0 = off). Beyond the reference, which
    # only evaluates recall after training (models.py:144-161).
    eval_recall_every: int = 0
    eval_recall_max_per_class: int = 10
    # Linear LR warmup over the first N epochs before the step decay
    # (from-scratch big-batch runs; 0 = reference behavior).
    warmup_epochs: float = 0.0
    # Metric the best-checkpoint / plateau / early-stop callbacks watch.
    # None = reference behavior (val_loss when validating, else loss).
    # Higher-is-better metrics (recall/accuracy) flip the callbacks to
    # max mode automatically — e.g. 'val_recall1' with eval_recall_every
    # stops an ArcFace run at its retrieval peak instead of riding the
    # train loss into overfit.
    monitor: Optional[str] = None
    # Decoupled weight decay for the 'adamw' optimizer (ignored by the
    # reference optimizer names). ViT-from-scratch recipes need it.
    weight_decay: float = 0.0
    # Staged mining: train the first N epochs with mining_warmup_mode
    # before switching to GENERATOR.negatives_selection_mode. Hard mining
    # from random init collapses (pos ~= neg -> loss = margin; Hermans et
    # al., and measured on this repo's synthetic set —
    # docs/BENCHMARKS.md "Config 2"); a semihard warm start is the proven
    # fix. 0 = off (reference behavior: one fixed mode,
    # datagenerators.py:188-199). Resume-safe: the active mode is a pure
    # function of the epoch number.
    mining_warmup_epochs: int = 0
    mining_warmup_mode: str = "semihard"

    def __post_init__(self):
        if self.optimizer not in _VALID_OPTIMIZERS:
            raise ConfigError(
                f"TRAIN.optimizer must be one of {_VALID_OPTIMIZERS}, "
                f"got {self.optimizer!r}")
        if self.mining_warmup_epochs < 0:
            raise ConfigError("TRAIN.mining_warmup_epochs must be >= 0")
        if self.mining_warmup_mode not in _VALID_MINING:
            raise ConfigError(
                f"TRAIN.mining_warmup_mode must be one of {_VALID_MINING}, "
                f"got {self.mining_warmup_mode!r}")
        if ("recall" in (self.monitor or "")
                and self.eval_recall_every <= 0):
            raise ConfigError(
                "TRAIN.monitor watches a recall metric but "
                "eval_recall_every is 0 — the metric would never exist")
        if self.learning_rate <= 0:
            raise ConfigError("TRAIN.learning_rate must be positive")


@dataclass
class SoftmaxPretrainConfig(_SectionBase):
    """``SOFTMAX_PRETRAINING:`` section (cf. ``configs/template.yml:41-51``)."""

    optimizer: str = "radam"
    learning_rate: float = 1e-4
    decay_factor: float = 0.99
    step_size: int = 1
    batch_size: int = 16
    val_steps: int = 100
    steps_per_epoch: int = 500
    n_epochs: int = 5
    augmentations: Optional[str] = None
    input_shape: Optional[Sequence[int]] = None  # injected from MODEL


@dataclass
class EncodingsConfig(_SectionBase):
    """``ENCODINGS:`` section (cf. ``configs/road_signs_apollo.yml:54-59``).

    The reference parses ``centers_only`` and ``knn_k`` but never consumes
    them (declared-but-unimplemented surface); here both are implemented:
    ``centers_only`` stores one mean encoding per class, ``knn_k`` sets the
    k of the kNN classifier.
    """

    save_encodings: bool = True
    centers_only: bool = False
    max_num_samples_of_each_class: int = 30
    knn_k: int = 1


@dataclass
class GeneralConfig(_SectionBase):
    """``GENERAL:`` section (cf. ``configs/road_signs_apollo.yml:61-64``)."""

    project_name: str = "project"
    work_dir: str = "work_dirs/"
    tensorboard_callback: bool = False
    wandb_callback: bool = False
    # Reference selects GPUs by CUDA_VISIBLE_DEVICES (``tools/train.py:121-131``);
    # kept for schema compatibility, ignored on TPU (mesh comes from MESH:).
    gpu_ids: Optional[str] = None
    seed: int = 42


@dataclass
class MeshConfig(_SectionBase):
    """``MESH:`` section (new, TPU-specific).

    Shapes the ``jax.sharding.Mesh``. ``data=-1`` means "all remaining
    devices"; the default ``data=1`` keeps training single-device — like
    the reference, parallelism is opt-in (its gate is ``gpu_ids``,
    ``tools/train.py:121-140``). The global batch must divide by the data
    axis.
    """

    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.model < 1:
            raise ConfigError("MESH.model must be >= 1")
        if self.data < -1 or self.data == 0:
            raise ConfigError("MESH.data must be -1 or >= 1")


@dataclass
class PerformanceConfig(_SectionBase):
    """``PERFORMANCE:`` section (new, TPU-specific)."""

    compute_dtype: str = "bfloat16"
    params_dtype: str = "float32"
    remat: bool = False
    donate_state: bool = True
    # DEPRECATED r2: the fused Pallas batch-hard kernel was cut after
    # measurement (docs/MINING.md "Pallas: win or cut"); accepted for
    # config compatibility, warned-and-ignored.
    use_pallas_mining: bool = False
    # EXPERIMENT (measured SLOWER end-to-end — leave off): Pallas
    # small-spatial 3x3 conv path for ResNet-family backbones
    # (ops/fused_conv.py): shifted-tap MXU matmul kernels (fwd + dgrad +
    # wgrad, BN/ReLU prologue fusion), numerics to bf16 rounding,
    # nn.Conv-interchangeable params, SPMD custom_partitioning wrappers
    # on >1-device meshes. The r4 real-chip A/B recorded 0.796x/0.809x
    # vs XLA convs (per-pallas_call overhead + lost fusion —
    # docs/BENCHMARKS.md "End-to-end verdict (r4)"); kept available and
    # tested for future toolchain revisions.
    pallas_conv: bool = False
    # Sanitizer mode (SURVEY.md §5 race-detection analog): raise on any
    # NaN produced inside jitted computations.
    debug_nans: bool = False
    # Let Orbax finish checkpoint writes on its background thread while
    # training continues (epoch-end save no longer blocks the loop).
    async_checkpoint: bool = False
    # BatchNorm running-stats momentum. Keras default 0.99 needs ~1k steps
    # to warm eval statistics; short-run / from-scratch configs should use
    # 0.9 (the reference trains from pretrained weights and never hits
    # this — from-scratch EfficientNet evals collapse until stats warm).
    bn_momentum: float = 0.99
    # EMA of parameters for eval/export (0 = off). Checkpointed with the
    # optimizer state; encodings export and recall eval use EMA weights.
    ema_decay: float = 0.0
    # Double-buffered host->device transfer: enqueue batch N+1's async
    # device_put while step N computes (train/loop.py:_device_prefetch).
    device_prefetch: bool = True
    # Store the train state's small f32 leaves (BN scale/bias/stats +
    # their optimizer moments) as contiguous flat vectors between steps
    # so XLA memory-space-assignment stages a few large buffers instead
    # of hundreds of tiny ones (train/packing.py). Exact — pure layout
    # change, bit-identical steps (tests/test_packing.py); measured
    # +0.33 ms/step on the headline (tools/perf_probe8.py,
    # docs/BENCHMARKS.md). Applies to single-device training; mesh paths
    # keep the plain pytree layout (shardings attach to leaves).
    param_packing: bool = True
    # In-RAM cache of decoded+resized uint8 images, in megabytes (0 =
    # off). Exact: augmentation draws fresh RNG on device, so cached
    # pixels equal a re-decode. Sized for the dataset at input_shape
    # (e.g. 12.8k images @96px = ~350 MB); epochs after the first skip
    # the host jpeg-decode wall entirely (data/pipeline.DecodeCache).
    decode_cache_mb: int = 0
    # Recall-eval decoded-image cache, in megabytes (0 = off): the eval
    # DB/query path lists are fixed across epochs, so warm evals skip
    # host decode entirely and only re-ENCODE with the current params
    # (train/loop.py:evaluate_recall). Exact — cached uint8 pixels equal
    # a re-decode. Default sized for ~10k images @96px.
    eval_decode_cache_mb: int = 512
    # DCT-prescaled JPEG decode in the native loader: ~1.5x decode
    # throughput at >= 2:1 downscales, at a measured mean ~1.2 gray-level
    # deviation from the exact cv2 path (data/native_loader.py). Off by
    # default (exact decode).
    fast_decode: bool = False

    def __post_init__(self):
        if self.compute_dtype not in _VALID_DTYPES:
            raise ConfigError(
                f"PERFORMANCE.compute_dtype must be one of {_VALID_DTYPES}")
        if self.params_dtype not in _VALID_DTYPES:
            raise ConfigError(
                f"PERFORMANCE.params_dtype must be one of {_VALID_DTYPES}")


@dataclass
class Params(_SectionBase):
    """Full experiment config; mapping-compatible with the reference's
    ``{'dataloader': ..., 'generator': ..., ...}`` dict
    (``embedding_net/utils.py:180-185``)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    encodings: EncodingsConfig = field(default_factory=EncodingsConfig)
    general: GeneralConfig = field(default_factory=GeneralConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    performance: PerformanceConfig = field(default_factory=PerformanceConfig)
    softmax: Optional[SoftmaxPretrainConfig] = None

    def __contains__(self, key: str) -> bool:
        # reference idiom: `'softmax' in params` is False unless the
        # SOFTMAX_PRETRAINING section was present (utils.py:187-194)
        return getattr(self, key, None) is not None


def _build_section(cls, raw: Mapping[str, Any], section: str):
    if raw is None:
        raw = {}
    if not isinstance(raw, Mapping):
        raise ConfigError(f"{section} section must be a mapping, got {type(raw)}")
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs, unknown = {}, []
    for key, value in raw.items():
        if key in known:
            kwargs[key] = value
        else:
            unknown.append(key)
    if unknown:
        raise ConfigError(
            f"Unknown key(s) {unknown} in {section} section "
            f"(valid: {sorted(known)})")
    return cls(**kwargs)


# Keys normalized before dataclass construction: reference-era aliases.
_DATALOADER_ALIASES = {"csv_file": "train_csv_file"}
_GENERATOR_ALIASES = {"augmentation_type": "augmentations",
                      "augmentations_type": "augmentations"}


def _apply_aliases(raw: Optional[Mapping[str, Any]],
                   aliases: Mapping[str, str]) -> dict:
    out = dict(raw or {})
    for old, new in aliases.items():
        if old in out and new not in out:
            out[new] = out.pop(old)
        else:
            out.pop(old, None)
    return out


def parse_params(filename: str) -> Params:
    """YAML experiment file -> validated :class:`Params`.

    Mirrors ``embedding_net/utils.py:156-197``: same section names, same
    key spellings, with GENERATOR.input_shape injected from MODEL
    (``utils.py:176``) and the softmax section mirrored into ``params.softmax``
    only when ``SOFTMAX_PRETRAINING`` is present (``utils.py:187-194``).
    """
    import yaml
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, Mapping):
        raise ConfigError(f"Config file {filename} is not a YAML mapping")
    return params_from_dict(cfg)


def params_from_dict(cfg: Mapping[str, Any]) -> Params:
    """Build :class:`Params` from an already-loaded config mapping."""
    model = _build_section(ModelConfig, cfg.get("MODEL"), "MODEL")
    dataloader = _build_section(
        DataLoaderConfig,
        _apply_aliases(cfg.get("DATALOADER"), _DATALOADER_ALIASES),
        "DATALOADER")
    generator = _build_section(
        GeneratorConfig,
        _apply_aliases(cfg.get("GENERATOR"), _GENERATOR_ALIASES),
        "GENERATOR")
    train = _build_section(TrainConfig, cfg.get("TRAIN"), "TRAIN")
    encodings = _build_section(EncodingsConfig, cfg.get("ENCODINGS"), "ENCODINGS")
    general = _build_section(GeneralConfig, cfg.get("GENERAL"), "GENERAL")
    mesh = _build_section(MeshConfig, cfg.get("MESH"), "MESH")
    performance = _build_section(
        PerformanceConfig, cfg.get("PERFORMANCE"), "PERFORMANCE")

    generator.input_shape = model.input_shape

    softmax = None
    if "SOFTMAX_PRETRAINING" in cfg and cfg["SOFTMAX_PRETRAINING"] is not None:
        softmax = _build_section(
            SoftmaxPretrainConfig, cfg["SOFTMAX_PRETRAINING"],
            "SOFTMAX_PRETRAINING")
        softmax.input_shape = model.input_shape
        if softmax.augmentations is None:
            softmax.augmentations = generator.augmentations

    return Params(model=model, dataloader=dataloader, generator=generator,
                  train=train, encodings=encodings, general=general,
                  mesh=mesh, performance=performance, softmax=softmax)
