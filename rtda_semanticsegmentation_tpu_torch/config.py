"""Configuration of the ported slice.

The fields of the JAX package's ``config.py::ModelConfig`` and
``AugmentConfig`` that the port reads, with the same names and defaults
(``tests/test_torch_bisenet.py`` holds them equal). The port keeps its own
copy so that its serving path, and ``chip_smoke.py`` on a GPU machine,
import nothing of the JAX package. The port's functions read these configs
by attribute, so the JAX package's own config objects work as well.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str = "bisenet"  # bisenet (deeplabv2 not ported yet)
    context_path: str = "resnet18"  # resnet18 (resnet101 not ported yet)
    num_classes: int = 19
    compute_dtype: str = "bfloat16"
    # int8 PTQ serving: convs with >= quant_min_ch input channels whose flax
    # path contains no quant_skip substring run on the s8 kernel
    quant: str = "none"  # none | calib | int8_frozen
    quant_min_ch: int = 128
    quant_clip: float = 1.0  # 1.0 = exact per-channel max|x|, < 1 a quantile
    quant_skip: Tuple[str, ...] = ()


@dataclass(frozen=True)
class AugmentConfig:
    # ImageNet normalization of the input frames
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
