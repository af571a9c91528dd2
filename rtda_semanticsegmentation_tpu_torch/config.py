"""Configuration of the ported slices.

The fields of the JAX package's ``config.py`` dataclasses that the port
reads, with the same names and defaults (``tests/test_torch_bisenet.py``
and ``tests/test_torch_cli.py`` hold them equal). The port keeps its own
copy so that it, and ``chip_smoke.py`` on a GPU machine, import nothing of
the JAX package. The port's functions read these configs by attribute, so
the JAX package's own config objects work as well.

The port's own additions, which the JAX package lacks, are listed in
:data:`PORT_ONLY_FIELDS` and :data:`PORT_ONLY_PRESETS`: SegFormer's MiT
widths and its ``segformer_cityscapes`` preset (``models/segformer.py``).

``MeshConfig`` is the JAX package's: ``data x model`` spans the ranks of
a ``torch.distributed`` process group, one device each; the batch is split
over ``data`` and the wide conv kernels' output channels over ``model``
(``parallel/mesh.py``, ``parallel/tp.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str = "bisenet"  # bisenet | deeplabv2 | segformer
    context_path: str = "resnet18"  # resnet18 | resnet101 (BiSeNet's)
    num_classes: int = 19
    compute_dtype: str = "bfloat16"
    # the JAX package's phase-conv RGB stems, an exact rearrangement of the
    # plain conv for the TPU. Carried for config parity: the port's plain
    # stems compute the same function at either value (the phase form
    # measured slower on the H100, PERF.md)
    fast_input: bool = False
    # int8 PTQ serving: convs with >= quant_min_ch input channels whose flax
    # path contains no quant_skip substring run on the s8 kernel
    quant: str = "none"  # none | calib | int8 | int8_frozen
    quant_min_ch: int = 128
    quant_clip: float = 1.0  # 1.0 = exact per-channel max|x|, < 1 a quantile
    quant_skip: Tuple[str, ...] = ()
    pretrained_backbone: Optional[str] = None  # converted .npz weights
    disc_ndf: int = 64  # FCDiscriminator base width
    # SegFormer's MiT encoder (models/segformer.py), MiT-B5 by default: per
    # stage the width, blocks, heads (each width / heads wide) and the
    # keys' spatial-reduction ratio; the Mix-FFN's widening; the head's width
    mit_embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    mit_depths: Tuple[int, ...] = (3, 6, 40, 3)
    mit_num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    mit_sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mit_mlp_ratio: int = 4
    decoder_dim: int = 768


@dataclass(frozen=True)
class AugmentConfig:
    """The on-device train augmentation (``ops/augment.py``): the stochastic
    ops fire with probability ``prob`` each, in the order [HFlip] ->
    ColorJitter -> ISONoise -> CoarseDropout, then Normalize."""

    pipeline: str = "all_four_combined"
    # one of: no_new_aug | hflip_only | colorjitter_only | isonoise_only |
    #         coarsedropout_only | all_four_combined | all_four_plus_hflip
    prob: float = 0.5
    cj_brightness: float = 0.3
    cj_contrast: float = 0.3
    cj_saturation: float = 0.3
    cj_hue: float = 0.1
    iso_intensity: Tuple[float, float] = (0.1, 0.3)
    iso_color_shift: Tuple[float, float] = (0.01, 0.05)
    cd_max_holes: int = 8
    cd_min_holes: int = 1
    cd_hole_size: Tuple[int, int] = (20, 60)
    cd_fill: float = 0.0
    # ImageNet normalization of the input frames
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # storage dtype of the stochastic chain: bfloat16 | float32 | uint8
    aug_dtype: str = "bfloat16"

    @property
    def flags(self) -> Tuple[bool, bool, bool, bool]:
        """(hflip, colorjitter, isonoise, coarsedropout) enabled switches."""
        p = self.pipeline
        return (
            p in ("hflip_only", "all_four_plus_hflip"),
            p in ("colorjitter_only", "all_four_combined", "all_four_plus_hflip"),
            p in ("isonoise_only", "all_four_combined", "all_four_plus_hflip"),
            p in ("coarsedropout_only", "all_four_combined", "all_four_plus_hflip"),
        )


@dataclass(frozen=True)
class DataConfig:
    train_dataset: str = "gta5"  # gta5 | cityscapes | synthetic
    val_dataset: str = "cityscapes"
    gta5_path: str = "./data/GTA5"
    cityscapes_path: str = "./data/Cityscapes"
    gta5_labels_subdir: str = "labels_trainids"
    gta5_convert_on_the_fly: bool = False
    gta5_size: Tuple[int, int] = (720, 1280)  # (H, W)
    cityscapes_size: Tuple[int, int] = (512, 1024)
    train_size_override: Optional[Tuple[int, int]] = None
    eval_size_override: Optional[Tuple[int, int]] = None
    # host decode threads; -1 = min(32, cpu_count), 0 = one thread
    num_workers: int = -1
    prefetch_batches: int = 2  # batches copied to the device ahead of the step
    eval_batch_size: int = 8
    # the adversarial target stream
    adversarial_source_dataset: str = "gta5"
    adversarial_target_dataset: str = "cityscapes"
    adversarial_target_split: str = "train"
    synthetic_length: int = 64  # samples in the synthetic dataset
    # the native C++ host decode (data/native.py): 'auto' uses it when the
    # library builds, 'on' requires it, 'off' forces PIL; both decode the
    # same bits (tests/test_torch_native_data.py)
    native_decode: str = "auto"
    # the decoded-sample disk cache (data/cache.py): decode each PNG once,
    # then read the raw post-resize tensors; None = off
    decoded_cache_dir: Optional[str] = None

    def resolved_num_workers(self) -> int:
        if self.num_workers > 0:
            return self.num_workers
        if self.num_workers == 0:
            return 1
        import os

        return min(32, os.cpu_count() or 1)


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"  # sgd | adam | adamw
    learning_rate: float = 1e-4
    # L2 into the gradient, as torch's SGD/Adam; adamw: decoupled, the
    # weights scaled by 1 - lr * weight_decay before the step
    weight_decay: float = 1e-4
    sgd_momentum: float = 0.9
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    poly_power: float = 0.9

    @staticmethod
    def default_lr(name: str) -> float:
        return {"sgd": 2.5e-4, "adam": 1e-4, "adamw": 6e-5}[name]


@dataclass(frozen=True)
class AdversarialConfig:
    """Output-space adversarial adaptation: the FC-Discriminator's weight in
    G's loss, its input pooling and its optimizer."""

    enabled: bool = False
    lambda_adv: float = 0.002  # weight of G's adversarial BCE term
    # block-mean the logits by this factor before the softmax D sees; 1 = the
    # full-resolution maps of the reference
    disc_downsample: int = 1
    # warm-start D from a converted .npz (its optimizer state starts fresh)
    pretrained_discriminator: Optional[str] = None
    disc_optimizer: str = "adam"  # adam | sgd (momentum 0.9)
    disc_learning_rate: float = 2.5e-5
    disc_adam_b1: float = 0.9
    disc_adam_b2: float = 0.99
    disc_weight_decay: float = 0.0  # L2 into the gradient


@dataclass(frozen=True)
class LossConfig:
    ignore_index: int = 255
    use_lovasz: bool = False
    lovasz_weight: float = 0.5  # L = L_ce + w * L_lovasz
    lovasz_impl: str = "binned"  # binned (kernels K1/K2) | sort (exact)
    lovasz_interp: bool = True  # fg/bg-split midpoint backward
    lovasz_bins: int = 256
    aux_weight: float = 0.0  # BiSeNet aux-head CE weight; 0 = reference parity


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) layout (the JAX package's ``MeshConfig``): ``data
    x model`` ranks, one device each. The global batch is split over
    ``data`` (-1: every rank not claimed by ``model``); the output channels
    of the wide conv kernels over ``model`` (``parallel/tp.py``)."""

    data: int = -1
    model: int = 1
    data_axis_name: str = "data"
    model_axis_name: str = "model"


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 42
    epochs: int = 50
    batch_size: int = 8
    checkpoint_dir: str = "./checkpoints"
    best_checkpoint_name: str = "best_miou"
    periodic_checkpoint_name: str = "latest"
    save_checkpoint_freq_epoch: int = 5
    resume_checkpoint: Optional[str] = None  # latest | best | a path
    validate_freq_epoch: int = 1
    print_freq_batch: int = 100
    log_images_freq_epoch: int = 10
    latency_iterations: int = 100
    warmup_iterations: int = 10
    remat: bool = False  # checkpoint G's forward: the backward recomputes its activations
    # run each loaded batch through N optimizer steps (fresh augmentation
    # draws each); echoed steps count toward steps_per_epoch and the poly LR
    data_echo: int = 1
    steps_per_epoch: Optional[int] = None  # None: from the dataset's length
    # evaluate the best model through the int8 PTQ path at the end of the run
    final_int8_eval: bool = False
    # a torch.profiler trace of N train steps after 3 warm ones; 0 = off
    profile_steps: int = 0
    # raise NonFiniteLossError when a logged train metric is NaN/Inf
    halt_on_nonfinite: bool = True


@dataclass(frozen=True)
class ObservabilityConfig:
    backend: str = "auto"  # auto | wandb | jsonl | null
    project: str = "RTDA-SemSeg"
    entity: str = "RTDA-SemSeg"
    run_name: Optional[str] = None
    log_dir: str = "./logs"
    # per-module parameter and gradient L2 norms (``watch/...``) computed
    # by the step and logged every N steps; 0 = off
    watch_freq_steps: int = 0
    # mirror saved checkpoints to the W&B run (an 'artifact' event in jsonl)
    upload_checkpoints: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    adversarial: AdversarialConfig = field(default_factory=AdversarialConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)

    @property
    def train_mode(self) -> str:
        """One of vanilla | lovasz | adversarial | adversarial_lovasz."""
        if self.adversarial.enabled:
            return "adversarial_lovasz" if self.loss.use_lovasz else "adversarial"
        return "lovasz" if self.loss.use_lovasz else "vanilla"

    @property
    def train_size(self) -> Tuple[int, int]:
        if self.data.train_size_override is not None:
            return self.data.train_size_override
        if self.data.train_dataset == "cityscapes":
            return self.data.cityscapes_size
        return self.data.gta5_size

    @property
    def eval_size(self) -> Tuple[int, int]:
        return self.data.eval_size_override or self.data.cityscapes_size

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def get_preset(name: str) -> ExperimentConfig:
    """The JAX package's presets (``BASELINE.json['configs']``)."""
    base = ExperimentConfig()
    if name == "bisenet_source_small":
        return base.replace(
            data=dataclasses.replace(base.data, gta5_size=(256, 512), cityscapes_size=(256, 512),
                                     eval_batch_size=2),
            augment=dataclasses.replace(base.augment, pipeline="no_new_aug"),
            train=dataclasses.replace(base.train, batch_size=2),
        )
    if name == "bisenet_source_aug":
        return base.replace(
            data=dataclasses.replace(base.data, gta5_size=(512, 1024)),
            augment=dataclasses.replace(base.augment, pipeline="all_four_combined"),
        )
    if name == "bisenet_adversarial":
        return base.replace(adversarial=dataclasses.replace(base.adversarial, enabled=True))
    if name == "bisenet_adversarial_lovasz":
        return base.replace(
            adversarial=dataclasses.replace(base.adversarial, enabled=True),
            loss=dataclasses.replace(base.loss, use_lovasz=True),
            augment=dataclasses.replace(base.augment, pipeline="all_four_combined"),
        )
    if name == "deeplabv2_cityscapes":
        return base.replace(
            model=dataclasses.replace(base.model, name="deeplabv2"),
            data=dataclasses.replace(base.data, train_dataset="cityscapes"),
            optimizer=dataclasses.replace(base.optimizer, name="sgd", learning_rate=2.5e-4),
            augment=dataclasses.replace(base.augment, pipeline="no_new_aug"),
        )
    if name == "segformer_cityscapes":
        # SegFormer's Cityscapes recipe (NVlabs' segformer.*.city.160k):
        # AdamW 6e-5, decay 0.01, poly power 1.0
        return base.replace(
            model=dataclasses.replace(base.model, name="segformer"),
            data=dataclasses.replace(base.data, train_dataset="cityscapes"),
            optimizer=dataclasses.replace(base.optimizer, name="adamw", learning_rate=6e-5, weight_decay=0.01,
                                          poly_power=1.0),
            augment=dataclasses.replace(base.augment, pipeline="no_new_aug"),
        )
    raise ValueError(f"Unknown preset {name!r}. Presets: {', '.join(PRESETS)}")


PORT_ONLY_FIELDS = ("mit_embed_dims", "mit_depths", "mit_num_heads", "mit_sr_ratios", "mit_mlp_ratio",
                    "decoder_dim")  # of ModelConfig
PORT_ONLY_PRESETS = ("segformer_cityscapes",)
PRESETS = (
    "bisenet_source_small",
    "bisenet_source_aug",
    "deeplabv2_cityscapes",
    "bisenet_adversarial",
    "bisenet_adversarial_lovasz",
) + PORT_ONLY_PRESETS
