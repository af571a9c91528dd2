"""Weight bridge between the JAX package's flat variables and the port.

The JAX package keys its weights by flat ``collection/path/name`` strings
(the keys of its ``.npz`` files): ``params/<path>/kernel`` (HWIO),
``params/<path>/bias|scale``, ``batch_stats/<path>/mean|var``,
``quant_stats/<path>/in_absmax|in_mean|calib_batches`` and
``quant_frozen/<path>/wq|sw|c``. The port's modules carry the same paths,
so a port ``state_dict`` key is the flax path joined by dots plus a
PyTorch tensor name. Conv kernels are transposed HWIO <-> OIHW; ``wq``
stays HWIO, the layout the int8 kernel takes. ``quant_frozen/<path>/a|b``
(the BatchNorm folded into the int8 kernel's epilogue) exist only in the
port; the JAX models ignore them.

The torch-side converters (:func:`convert_torch_checkpoint`,
:func:`convert_full_torch_checkpoint`, :func:`unwrap_reference_checkpoint`
and their helpers) are copies of the JAX package's: they map a torchvision
or reference ``state_dict`` onto the flat flax-path arrays that
``cli/convert_torch_weights.py`` saves as an ``.npz``, the same file the JAX
package's converter writes, and :func:`load_npz_into_state` grafts it into
a port model. Either package loads either one's file.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

QUANT_STATS = ("in_absmax", "in_mean", "calib_batches")
QUANT_FROZEN = ("wq", "sw", "c", "a", "b")
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _port_name(collection: str, name: str) -> str:
    if collection == "params" and name in ("kernel", "scale"):
        return "weight"
    if collection == "params" and name == "bias":
        return "bias"
    if collection == "batch_stats" and name in _STATS:
        return _STATS[name]
    if (collection == "quant_stats" and name in QUANT_STATS) or (
        collection == "quant_frozen" and name in QUANT_FROZEN
    ):
        return name
    raise KeyError(f"no port counterpart for variable {collection}/.../{name}")


def from_jax_variables(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX variables (``collection/path/name`` keys) -> port state_dict."""
    out = {}
    for key, value in flat.items():
        collection, *path, name = key.split("/")
        arr = np.array(value)  # a writable copy (jax arrays export read-only)
        if collection == "params" and name == "kernel":
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        out[".".join(path + [_port_name(collection, name)])] = torch.from_numpy(arr)
    return out


def to_jax_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port state_dict -> flat JAX variables; the inverse of
    :func:`from_jax_variables`."""
    out = {}
    for key, tensor in state.items():
        *path, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        p = "/".join(path)
        if name == "weight" and arr.ndim == 4:
            out[f"params/{p}/kernel"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif name == "weight":
            out[f"params/{p}/scale"] = arr
        elif name == "bias":
            out[f"params/{p}/bias"] = arr
        elif name in _STATS_BACK:
            out[f"batch_stats/{p}/{_STATS_BACK[name]}"] = arr
        elif name in QUANT_STATS:
            out[f"quant_stats/{p}/{name}"] = arr
        elif name in QUANT_FROZEN:
            out[f"quant_frozen/{p}/{name}"] = arr
        else:
            raise KeyError(f"no JAX counterpart for port tensor {key!r}")
    return out


_STAGE_BLOCKS = {18: (2, 2, 2, 2), 101: (3, 4, 23, 3)}


def _torch_resnet_key_map(depth: int) -> Iterator[Tuple[str, str]]:
    """(torch_key_prefix, flax_path_prefix) pairs for a torchvision ResNet.

    flax paths are relative to the ``resnet`` module of ``ResNetFeatures``.
    """
    yield "conv1", "stem/conv"
    yield "bn1", "stem/bn"
    blocks = _STAGE_BLOCKS[depth]
    n_convs = 2 if depth == 18 else 3
    for stage, n_blocks in enumerate(blocks, start=1):
        for b in range(n_blocks):
            for c in range(1, n_convs + 1):
                yield (
                    f"layer{stage}.{b}.conv{c}",
                    f"layer{stage}_{b}/conv{c}/conv",
                )
                yield (
                    f"layer{stage}.{b}.bn{c}",
                    f"layer{stage}_{b}/conv{c}/bn",
                )
            yield (
                f"layer{stage}.{b}.downsample.0",
                f"layer{stage}_{b}/downsample/conv",
            )
            yield (
                f"layer{stage}.{b}.downsample.1",
                f"layer{stage}_{b}/downsample/bn",
            )


_BN_PARTS = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def convert_resnet_state_dict(
    state: Dict[str, np.ndarray], depth: int, flax_root: str
) -> Dict[str, np.ndarray]:
    """Map a torchvision-style ResNet state_dict to flat flax-path arrays.

    ``flax_root`` is the dotted module path prefix of the ResNet inside the
    target model, e.g. ``context_path/resnet`` (BiSeNet) or ``resnet``
    (DeepLabV2). Unmatched torch keys (fc head, ASPP, num_batches_tracked)
    are skipped — the reference's ``strict=False`` semantics.
    """
    out: Dict[str, np.ndarray] = {}
    for torch_prefix, flax_prefix in _torch_resnet_key_map(depth):
        conv_key = f"{torch_prefix}.weight"
        if flax_prefix.endswith("/conv") and conv_key in state:
            w = np.asarray(state[conv_key])
            out[f"params/{flax_root}/{flax_prefix}/kernel"] = w.transpose(
                2, 3, 1, 0
            )
            continue
        if flax_prefix.endswith("/bn"):
            for part, (collection, name) in _BN_PARTS.items():
                k = f"{torch_prefix}.{part}"
                if k in state:
                    out[f"{collection}/{flax_root}/{flax_prefix}/{name}"] = (
                        np.asarray(state[k])
                    )
    return out


def strip_key_prefix(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the first dotted component of every key (reference
    ``deeplabv2.py:181-186``, for caffe-style 'Scale.layer1...' checkpoints)."""
    return {k.split(".", 1)[1]: v for k, v in state.items() if "." in k}


def looks_prefixed(state: Dict[str, np.ndarray]) -> bool:
    return not any(
        k.startswith(("conv1.", "bn1.", "layer1.")) for k in state
    )


def convert_torch_checkpoint(
    state: Dict[str, np.ndarray], model_name: str, depth: int
) -> Dict[str, np.ndarray]:
    """Full conversion for a target model family."""
    state = {k: np.asarray(v) for k, v in state.items()}
    if looks_prefixed(state):
        state = strip_key_prefix(state)
    root = {"bisenet": "context_path/resnet", "deeplabv2": "resnet"}[model_name]
    return convert_resnet_state_dict(state, depth, root)


def _t_conv(w: np.ndarray) -> np.ndarray:
    """torch (O, I, kH, kW) -> flax (kH, kW, I, O)."""
    return np.asarray(w).transpose(2, 3, 1, 0)


def _map_convbn(state, tp: str, fp: str, out) -> None:
    """Reference ``ConvBlock`` (conv1 WITH bias -> bn -> relu,
    ``build_bisenet.py:9-19``) onto our bias-free ``ConvBN``.

    Exact bias fold: BN tracks statistics of ``Wx + b``, so the identical
    no-bias module is BN'(Wx) with ``running_mean' = running_mean - b``
    (same variance, same affine) — eval outputs are bit-equal and training
    continues with consistent statistics.
    """
    out[f"params/{fp}/conv/kernel"] = _t_conv(state[f"{tp}.conv1.weight"])
    mean = np.asarray(state[f"{tp}.bn.running_mean"])
    bias_k = f"{tp}.conv1.bias"
    if bias_k in state:
        mean = mean - np.asarray(state[bias_k])
    out[f"params/{fp}/bn/scale"] = np.asarray(state[f"{tp}.bn.weight"])
    out[f"params/{fp}/bn/bias"] = np.asarray(state[f"{tp}.bn.bias"])
    out[f"batch_stats/{fp}/bn/mean"] = mean
    out[f"batch_stats/{fp}/bn/var"] = np.asarray(
        state[f"{tp}.bn.running_var"]
    )


def _map_conv_bias(state, tp: str, fp: str, out) -> None:
    """Plain ``nn.Conv2d`` (bias kept on both sides)."""
    out[f"params/{fp}/kernel"] = _t_conv(state[f"{tp}.weight"])
    out[f"params/{fp}/bias"] = np.asarray(state[f"{tp}.bias"])


def convert_full_torch_checkpoint(
    state: Dict[str, np.ndarray], model_name: str, depth: int
) -> Dict[str, np.ndarray]:
    """Convert a FULLY-TRAINED reference generator checkpoint — every
    module, not just the backbone — so reference-trained models serve and
    warm-start here without retraining.

    Key-name parity (reference module attributes):

    - BiSeNet (``build_bisenet.py:85-117``): ``saptial_path.convblock{1-3}``
      (the load-bearing typo), ``attention_refinement_module{1,2}``,
      ``supervision{1,2}``, ``feature_fusion_module.{convblock,conv1,conv2}``,
      final ``conv``, and the trunk under ``context_path.features.*``
      (``build_contextpath.py:8-16``; the same modules are aliased at
      ``context_path.conv1`` etc. — shared tensors, skipped).
    - DeepLabV2 (``deeplabv2.py:66-88``): torchvision-style trunk keys at
      the top level plus ``layer6.conv2d_list.{0-3}`` (ASPP) -> ``aspp/branch{0-3}``.
    - FC-Discriminator (``discriminator.py:25-48``): ``conv{1-4}`` and
      ``classifier``, all plain biased convs, names 1-1.

    Returns the flat flax-path dict ``load_npz_into_variables`` consumes.
    Generator conversions load via ``--pretrained_backbone`` (warm-start or
    serve the complete model); discriminator conversions load via
    ``--pretrained_discriminator``.
    """
    state = {k: np.asarray(v) for k, v in state.items()}
    out: Dict[str, np.ndarray] = {}
    if model_name == "bisenet":
        for i in (1, 2, 3):
            _map_convbn(
                state, f"saptial_path.convblock{i}",
                f"spatial_path/convblock{i}", out,
            )
        for i in (1, 2):
            arm = f"attention_refinement_module{i}"
            out[f"params/arm{i}/conv/kernel"] = _t_conv(
                state[f"{arm}.conv.weight"]
            )
            out[f"params/arm{i}/conv/bias"] = np.asarray(
                state[f"{arm}.conv.bias"]
            )
            out[f"params/arm{i}/bn/scale"] = np.asarray(
                state[f"{arm}.bn.weight"]
            )
            out[f"params/arm{i}/bn/bias"] = np.asarray(state[f"{arm}.bn.bias"])
            out[f"batch_stats/arm{i}/bn/mean"] = np.asarray(
                state[f"{arm}.bn.running_mean"]
            )
            out[f"batch_stats/arm{i}/bn/var"] = np.asarray(
                state[f"{arm}.bn.running_var"]
            )
            _map_conv_bias(state, f"supervision{i}", f"supervision{i}", out)
        _map_convbn(
            state, "feature_fusion_module.convblock", "ffm/convblock", out
        )
        _map_conv_bias(state, "feature_fusion_module.conv1", "ffm/conv1", out)
        _map_conv_bias(state, "feature_fusion_module.conv2", "ffm/conv2", out)
        _map_conv_bias(state, "conv", "final_conv", out)
        trunk = {
            k[len("context_path.features."):]: v
            for k, v in state.items()
            if k.startswith("context_path.features.")
        }
        if not trunk:
            raise KeyError(
                "no context_path.features.* keys — not a reference BiSeNet "
                "checkpoint? (use convert_torch_checkpoint for plain "
                "torchvision backbones)"
            )
        out.update(
            convert_resnet_state_dict(trunk, depth, "context_path/resnet")
        )
    elif model_name == "deeplabv2":
        out.update(convert_resnet_state_dict(state, depth, "resnet"))
        for i in range(4):
            _map_conv_bias(
                state, f"layer6.conv2d_list.{i}", f"aspp/branch{i}", out
            )
    elif model_name == "discriminator":
        # FC-Discriminator: five plain 4x4/s2 convs, 1-1 names
        # (reference ``discriminator.py:25-48``).
        for i in (1, 2, 3, 4):
            _map_conv_bias(state, f"conv{i}", f"conv{i}", out)
        _map_conv_bias(state, "classifier", "classifier", out)
    else:
        raise ValueError(f"unknown model {model_name!r}")
    return out


def unwrap_reference_checkpoint(obj, which: str = "G") -> Dict[str, np.ndarray]:
    """Pull a model state_dict out of a reference training checkpoint
    container. ``which='G'``: ``model_state_dict`` (vanilla,
    ``main.py:436``) or ``model_G_state_dict`` (adversarial,
    ``main_adversarial.py:396``; the same fallback order as
    ``utils.py:443-446``). ``which='D'``: ``model_D_state_dict``
    (``main_adversarial.py:397``). A bare state_dict passes through.
    """
    keys = (
        ("model_state_dict", "model_G_state_dict", "state_dict")
        if which == "G"
        else ("model_D_state_dict",)
    )
    if isinstance(obj, dict):
        for key in keys:
            if key in obj:
                return obj[key]
        # A training container that lacks the requested model is a user
        # error worth a clear message (e.g. asking for the discriminator
        # out of a vanilla checkpoint), not a downstream KeyError.
        container_keys = {
            "model_state_dict", "model_G_state_dict", "model_D_state_dict",
        }
        found = sorted(container_keys & obj.keys())
        if found:
            msg = (
                f"checkpoint container has {found} but no {'/'.join(keys)}"
            )
            if which == "D":
                msg += " — not an adversarial checkpoint?"
            raise ValueError(msg)
    return obj


def read_torch_checkpoint(path: str):
    """``torch.load`` a ``.pth`` on the CPU: with ``weights_only=True`` when
    the file holds only tensors and plain containers (a torchvision
    backbone), else, for a reference training container that pickles other
    objects, with ``weights_only=False`` (trusted files only)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_npz_into_state(state: Mapping[str, torch.Tensor], path: str, model_name: str) -> dict:
    """Graft a converted ``.npz`` (``cli/convert_torch_weights`` output) into
    a port state_dict, with the JAX package's semantics: shapes are checked,
    an unknown key raises, a model key the file lacks keeps its value, and
    ``params/supervision*`` (the train-only aux heads) load into a train
    model and are skipped for an eval model."""
    arrays = np.load(path)
    new = dict(state)
    loaded = 0
    for key in arrays.files:
        try:
            ((port_key, tensor),) = from_jax_variables({key: arrays[key]}).items()
        except KeyError:
            port_key = None
        if port_key not in state and key.startswith("params/supervision"):
            continue
        if port_key not in state:
            raise KeyError(
                f"npz key {key!r} not found in {model_name} variables - "
                "wrong --model or a converter/model naming drift"
            )
        old = state[port_key]
        if tuple(old.shape) != tuple(tensor.shape):
            raise ValueError(
                f"shape mismatch for {key}: model {tuple(old.shape)} vs "
                f"checkpoint {tuple(tensor.shape)}"
            )
        new[port_key] = tensor.to(device=old.device, dtype=old.dtype)
        loaded += 1
    if loaded == 0:
        raise ValueError(f"{path} contains no loadable arrays")
    return new
