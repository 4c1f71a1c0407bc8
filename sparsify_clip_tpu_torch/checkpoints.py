"""Weight bridge: JAX-trained weights into the port's modules.

The JAX package writes weights as a flat ``{slash/path: ndarray}`` dict
(``checkpoints.collect_host_arrays`` / ``save_weights``, an ``.npz``),
e.g. ``visual/transformer/resblock_0/attn/in_proj/kernel``.  This module
maps each path onto the port's open_clip parameter name and layout:

* ``.../resblock_N/...`` → ``...resblocks.N...``;
* LayerNorm ``<ln>/ln/scale|bias`` → ``<ln>.weight|bias``;
* dense kernels (in, out) → torch (out, in); the attention in_proj
  becomes ``attn.in_proj_weight`` / ``attn.in_proj_bias``;
* the patch conv kernel HWIO → OIHW (the inverse of the JAX side's
  OIHW→HWIO import, checkpoints.py:357);
* ``token_embedding`` → ``token_embedding.weight``.

A missing key, an extra key or a wrong shape raises before any weight
is written, so a partial load cannot happen.  Each array is cast to its
parameter's type on the way in (the compute type for serving weights).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _identity(a: np.ndarray) -> np.ndarray:
    return a


def _dense(a: np.ndarray) -> np.ndarray:
    return a.T


def _conv(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)  # HWIO → OIHW


def torch_name(path: str) -> Tuple[str, Callable[[np.ndarray], np.ndarray]]:
    """JAX flat path → (port parameter name, array layout transform)."""
    parts = []
    for p in path.split("/"):
        if p.startswith("resblock_"):
            parts += ["resblocks", p[len("resblock_"):]]
        else:
            parts.append(p)
    fn = _identity
    if len(parts) >= 2 and parts[-2] == "ln":
        parts[-2:] = ["weight" if parts[-1] == "scale" else parts[-1]]
    elif parts[-1] == "kernel":
        if parts[-2] == "conv1":
            parts[-1], fn = "weight", _conv
        elif parts[-2] == "in_proj":
            parts[-2:], fn = ["in_proj_weight"], _dense
        else:
            parts[-1], fn = "weight", _dense
    elif parts[-2:] == ["in_proj", "bias"]:
        parts[-2:] = ["in_proj_bias"]
    elif parts[-1] == "token_embedding":
        parts.append("weight")
    return ".".join(parts), fn


def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Fill every parameter of ``model`` from a JAX flat param dict."""
    params = dict(model.named_parameters())
    converted: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        name, fn = torch_name(path)
        if name not in params:
            raise KeyError(f"unexpected key {path!r} (port name {name!r})")
        converted[name] = np.require(fn(np.asarray(arr)), requirements=["C", "W"])
    missing = sorted(set(params) - set(converted))
    if missing:
        raise KeyError(f"missing keys for port parameters {missing}")
    for name, arr in converted.items():
        if arr.shape != tuple(params[name].shape):
            raise ValueError(
                f"shape mismatch for {name}: {arr.shape} vs {tuple(params[name].shape)}"
            )
    with torch.no_grad():
        for name, arr in converted.items():
            params[name].copy_(torch.from_numpy(arr))
    return model


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load an ``.npz`` written by the JAX package's ``save_weights``."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    with np.load(path) as data:
        return load_jax_params(model, {k: data[k] for k in data.files})
