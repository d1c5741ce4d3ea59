"""Weight bridge between the JAX package's parameter tree and this package's
modules, both ways.

The JAX param tree mirrors the upstream ``state_dict`` paths, and so do this
package's module names, so a leaf's dotted path is its ``state_dict`` key.
Only layouts differ, and this module inverts the JAX package's maps
(``cds_mvsnet_tpu/models/convert.py:86-104``):

- conv2d ``(kh, kw, I, O)`` HWIO -> ``(O, I, kh, kw)``;
- conv3d ``(kd, kh, kw, I, O)`` DHWIO -> ``(O, I, kd, kh, kw)``;
- transposed conv (the cost-reg UNet's 3-D ones and refinement's 2-D one),
  stored spatially flipped as ``(k..., I, O)`` -> un-flipped ``(I, O, k...)``
  for ``F.conv_transpose{2,3}d`` (stride 2, padding 1, output_padding 1);
- 1-D leaves (biases, norm parameters and statistics) unchanged.

:func:`params_to_jax` applies the maps the other way, so a checkpoint this
package writes (:func:`save_model`) is an ``.npz`` in the format of the JAX
package's ``save_params``, which its ``load_params`` reads.

A leaf that finds no parameter raises, as does a parameter no leaf fills;
only a model built without refinement skips the tree's ``refine_network``
leaves, as the JAX eval CLI does with ``--no_refinement``. Numpy only,
besides torch: the tree's leaves are numpy arrays (or anything
``np.asarray`` takes).

:func:`load_any_checkpoint` reads either kind of checkpoint the eval CLI
takes: a ``save_params`` ``.npz``, or an upstream ``.pth``/``.ckpt`` whose
``state_dict`` keys are this package's module paths (after a ``module.``
prefix is stripped), as ``cds_mvsnet_tpu/cli/test_cli.py:56-61`` with
``models/convert.py:65-108`` there.
"""

from __future__ import annotations

import io
import pickle
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = [
    "flatten_params",
    "unflatten_params",
    "save_params",
    "load_params",
    "params_from_jax",
    "params_to_jax",
    "load_any_checkpoint",
    "load_into",
    "save_model",
]

Params = dict[str, Any]

_DECONV_PATTERNS = [
    re.compile(r"^refine_network\.deconv\.weight$"),
    re.compile(r"^cost_regularization(\.\d+)?\.conv(7|9|11)\.conv\.weight$"),
]
REFINE_PREFIX = "refine_network."


def flatten_params(tree: Params, prefix: str = "") -> dict[str, Any]:
    """Nested tree -> ``{dotted.key: leaf}``."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = v
    return flat


def unflatten_params(flat: dict[str, Any]) -> Params:
    tree: Params = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


def save_params(path, tree: Params) -> None:
    """Write a tree as an ``.npz`` with dotted keys (the JAX package's format)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_params(tree).items()})


def load_params(path) -> Params:
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


def _to_torch_layout(key: str, arr: np.ndarray) -> np.ndarray:
    if any(p.match(key) for p in _DECONV_PATTERNS):
        spatial = tuple(range(arr.ndim - 2))
        arr = np.transpose(np.flip(arr, axis=spatial), (arr.ndim - 2, arr.ndim - 1, *spatial))
    elif arr.ndim == 4:
        arr = np.transpose(arr, (3, 2, 0, 1))
    elif arr.ndim == 5:
        arr = np.transpose(arr, (4, 3, 0, 1, 2))
    return arr


def _to_jax_layout(key: str, arr: np.ndarray) -> np.ndarray:
    if any(p.match(key) for p in _DECONV_PATTERNS):
        spatial = tuple(range(arr.ndim - 2))
        arr = np.flip(np.transpose(arr, (*range(2, arr.ndim), 0, 1)), axis=spatial)
    elif arr.ndim == 4:
        arr = np.transpose(arr, (2, 3, 1, 0))
    elif arr.ndim == 5:
        arr = np.transpose(arr, (2, 3, 4, 1, 0))
    return arr


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """A JAX param tree (numpy leaves) or the path of an ``.npz`` written by
    ``save_params`` -> ``{state_dict key: fp32 tensor}`` in torch layouts."""
    tree = load_params(params) if isinstance(params, (str, Path)) else params
    out = {}
    for key, leaf in flatten_params(tree).items():
        arr = _to_torch_layout(key, np.asarray(leaf, dtype=np.float32))
        out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out


def params_to_jax(model: torch.nn.Module) -> Params:
    """The model's parameters and BN statistics as a JAX param tree of fp32
    numpy leaves, in the JAX package's layouts."""
    flat = {}
    for key, t in model.state_dict().items():
        arr = t.detach().float().cpu().numpy()
        flat[key] = np.ascontiguousarray(_to_jax_layout(key, arr))
    return unflatten_params(flat)


def save_model(path, model: torch.nn.Module) -> None:
    """Write the model as an ``.npz`` that the JAX package's ``load_params``
    (and :func:`load_into`) reads."""
    save_params(path, params_to_jax(model))


def load_into(model: torch.nn.Module, params) -> None:
    """Load a JAX tree or ``.npz`` into ``model``; every leaf must land on a
    parameter or buffer of the same shape, and every one must be filled."""
    state = params_from_jax(params)
    own = model.state_dict()
    if not any(k.startswith(REFINE_PREFIX) for k in own):
        state = {k: v for k, v in state.items() if not k.startswith(REFINE_PREFIX)}
    unplaced = sorted(set(state) - set(own))
    if unplaced:
        raise KeyError(f"{len(unplaced)} leaves have no place in the model: {unplaced[:5]}")
    unfilled = sorted(set(own) - set(state))
    if unfilled:
        raise KeyError(f"{len(unfilled)} model entries have no leaf: {unfilled[:5]}")
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in state.items() if v.shape != own[k].shape]
    if bad:
        raise ValueError(f"shape mismatch (leaf, model): {bad[:5]}")
    model.load_state_dict(state, strict=True)


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickles torch checkpoints whose pickle holds classes this package
    does not ship (upstream stores its ConfigParser object there) as empty
    stand-ins."""

    _ALLOWED_PREFIXES = ("torch", "collections", "numpy", "builtins", "_codecs")

    def find_class(self, module, name):
        if module.startswith(self._ALLOWED_PREFIXES):
            return super().find_class(module, name)
        return type(name, (), {"__init__": lambda self, *a, **k: None,
                               "__setstate__": lambda self, state: None})


class _PickleShim:
    Unpickler = _TolerantUnpickler
    load = staticmethod(lambda f, **kw: _TolerantUnpickler(f, **kw).load())
    loads = staticmethod(lambda b, **kw: _TolerantUnpickler(io.BytesIO(b), **kw).load())


def _load_state_dict_file(path) -> dict[str, np.ndarray]:
    """An upstream checkpoint's ``state_dict`` (the file's, or the file
    itself) as fp32 numpy arrays in torch layouts: ``module.`` prefixes
    stripped, ``num_batches_tracked`` dropped."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False, pickle_module=_PickleShim)
    state = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    out = {}
    for k, v in state.items():
        k = k.replace("module.", "", 1) if k.startswith("module.") else k
        if not k.endswith("num_batches_tracked"):
            out[k] = v.detach().float().cpu().numpy()
    return out


def load_any_checkpoint(path) -> Params:
    """A ``save_params`` ``.npz`` or an upstream ``.pth``/``.ckpt`` as a JAX
    param tree, which :func:`load_into` (and ``build_model(params=...)``)
    takes."""
    if str(path).endswith(".npz"):
        return load_params(path)
    flat = _load_state_dict_file(path)
    return unflatten_params({k: np.ascontiguousarray(_to_jax_layout(k, v)) for k, v in flat.items()})
