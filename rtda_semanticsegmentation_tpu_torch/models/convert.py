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
"""

from __future__ import annotations

from typing import Dict, Mapping

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
