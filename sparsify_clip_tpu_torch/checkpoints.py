"""Checkpoints: the weight bridge to and from the JAX package, and the
port's full train state for exact resume.

The JAX package writes weights as a flat ``{slash/path: ndarray}`` dict
(``checkpoints.collect_host_arrays`` / ``save_weights``, an ``.npz``),
e.g. ``visual/transformer/resblock_0/attn/in_proj/kernel``.  This module
maps each path onto the port's open_clip parameter name and layout:

* ``.../resblock_N/...`` → ``...resblocks.N...``, and the JAX
  ``scan_layers`` layout, ``.../transformer/layers_scan/block/...`` with a
  leading layer axis (models/layers.py:300-319), unstacked into
  ``resblocks.0`` ... first;
* LayerNorm ``<ln>/ln/scale|bias`` → ``<ln>.weight|bias``;
* kernels by rank: a 2-D dense kernel (in, out) → torch (out, in), a 4-D
  conv kernel HWIO → OIHW (the inverse of the JAX side's OIHW→HWIO
  import, checkpoints.py:357); the attention in_proj becomes
  ``attn.in_proj_weight`` / ``attn.in_proj_bias``;
* ``token_embedding`` → ``token_embedding.weight``;
* the ResNet tower onto open_clip's ModifiedResNet names, the inverse of
  the JAX ``_map_visual_resnet`` (checkpoints.py:313-345):
  ``visual/stem_conv1`` → ``visual.conv1`` (and ``stem_bn1`` →
  ``bn1``), ``visual/layer{s}_block{i}`` → ``visual.layer{s}.{i}``,
  ``downsample_conv`` / ``downsample_bn`` → ``downsample.0`` /
  ``downsample.1``; BatchNorm ``scale`` → ``weight``, and in the JAX
  ``batch_stats`` collection ``mean`` / ``var`` → ``running_mean`` /
  ``running_var``.

A missing key, an extra key or a wrong shape raises before any weight
is written, so a partial load cannot happen.  Each array is cast to its
parameter's type on the way in (the compute type for serving weights).
:func:`save_weights` writes the inverse, parameters only, as the JAX
``save_weights(state.params, ...)``: an ``.npz`` under the JAX flat
keys, in the JAX layouts, which the JAX ``load_weights`` reads; a model
built with ``scan_layers`` writes the stacked ``layers_scan`` layout, as a
JAX ``scan_layers`` run does.

The full state (:func:`save_full`, :func:`restore_full`) keeps the JAX
names and the ``<checkpoint_dir>/<run_name>/step_<N>`` layout, in the
port's own format: one ``torch.save`` a step (``step_<N>.pt``) of the
model's ``state_dict`` (parameters and BatchNorm running statistics),
the AdamW state, the temperature, the device-augment generator's state,
the step and the config, written under a temporary name and then
renamed.

Over a process group of several ranks (JAX checkpoints.py:102-127) the
primary alone writes the weights npz and the full state and every rank
then waits at a barrier (an asynchronous save, at
:func:`wait_for_async_saves`); every rank restores from the same files.
A model laid out over the mesh (tensor parallelism, FSDP, ZeRO-1's
moments; ``model.layout``,
:class:`~sparsify_clip_tpu_torch.parallel.sharding.Layout`) is put back
together first, every rank taking part, so the files hold the model of
one process at full shape under the same keys, whatever the layout that
wrote them; loading one (:func:`load_jax_params`, :func:`restore_full`)
keeps each rank's pieces (a pipeline stage's rank, its stage's blocks).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparsify_clip_tpu_torch.parallel.multihost import barrier, is_primary
from sparsify_clip_tpu_torch.parallel.sharding import (
    full_optimizer_state, layout_of, load_optimizer_state,
)


def _identity(a: np.ndarray) -> np.ndarray:
    return a


def _kernel(a: np.ndarray) -> np.ndarray:
    """A JAX kernel in the port's layout, by rank: dense (in, out) → (out,
    in), conv HWIO → OIHW."""
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


# JAX ResNet module names → the port's (open_clip's) module path parts
_RESNET_MODULES = [
    (re.compile(r"stem_((?:conv|bn)\d+)$"), lambda m: [m.group(1)]),
    (re.compile(r"(layer\d+)_block(\d+)$"), lambda m: [m.group(1), m.group(2)]),
    (re.compile(r"downsample_conv$"), lambda m: ["downsample", "0"]),
    (re.compile(r"downsample_bn$"), lambda m: ["downsample", "1"]),
]
# BatchNorm leaves: the JAX params and batch_stats names → the port's
_BN_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def torch_name(path: str) -> Tuple[str, Callable[[np.ndarray], np.ndarray]]:
    """JAX flat path → (port parameter or buffer name, array layout transform)."""
    parts = []
    for p in path.split("/"):
        if p.startswith("resblock_"):
            parts += ["resblocks", p[len("resblock_"):]]
            continue
        for pattern, repl in _RESNET_MODULES:
            m = pattern.match(p)
            if m:
                parts += repl(m)
                break
        else:
            parts.append(p)
    fn = _identity
    if len(parts) >= 2 and parts[-2] == "ln":
        parts[-2:] = ["weight" if parts[-1] == "scale" else parts[-1]]
    elif parts[-1] == "kernel":
        if parts[-2] == "in_proj":
            parts[-2:], fn = ["in_proj_weight"], _kernel
        else:
            parts[-1], fn = "weight", _kernel
    elif parts[-2:] == ["in_proj", "bias"]:
        parts[-2:] = ["in_proj_bias"]
    elif parts[-1] == "token_embedding":
        parts.append("weight")
    elif parts[-1] in _BN_LEAVES:
        parts[-1] = _BN_LEAVES[parts[-1]]
    return ".".join(parts), fn


_SCAN = re.compile(r"^(?:(.*)/)?layers_scan/block/(.*)$")
_RESBLOCK = re.compile(r"^(?:(.*)/)?resblock_(\d+)/(.*)$")


def _join(*parts: Optional[str]) -> str:
    return "/".join(p for p in parts if p)


def unstack_scan_layers(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A JAX flat dict with the ``scan_layers`` stacks unstacked:
    ``<trunk>/layers_scan/block/<leaf>`` of shape (L, ...) →
    ``<trunk>/resblock_<i>/<leaf>`` for each i < L; other keys as they are."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        m = _SCAN.match(path)
        if m is None:
            out[path] = arr
            continue
        for i, layer in enumerate(np.asarray(arr)):
            out[_join(m.group(1), f"resblock_{i}", m.group(2))] = layer
    return out


def stack_scan_layers(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`unstack_scan_layers`: each trunk's
    ``resblock_<i>/<leaf>`` arrays stacked in block order as
    ``<trunk>/layers_scan/block/<leaf>`` (the JAX ``scan_layers`` layout);
    ndarrays, or tensors stacked on their device."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for path, arr in flat.items():
        m = _RESBLOCK.match(path)
        if m is None:
            out[path] = arr
        else:
            stacked = _join(m.group(1), "layers_scan/block", m.group(3))
            layers.setdefault(stacked, {})[int(m.group(2))] = arr
    for path, by_index in layers.items():
        arrays = [by_index[i] for i in range(len(by_index))]
        out[path] = (torch.stack if isinstance(arrays[0], torch.Tensor) else np.stack)(arrays)
    return out


def _convert(flat: Mapping[str, np.ndarray], targets: Dict[str, torch.Tensor],
             what: str) -> Dict[str, np.ndarray]:
    """Map every JAX path of ``flat`` onto ``targets`` (port name → tensor)
    and check that the keys cover them and the shapes agree."""
    converted: Dict[str, np.ndarray] = {}
    for path, arr in unstack_scan_layers(flat).items():
        name, fn = torch_name(path)
        if name not in targets:
            raise KeyError(f"unexpected key {path!r} (port name {name!r})")
        converted[name] = np.require(fn(np.asarray(arr)), requirements=["C", "W"])
    missing = sorted(set(targets) - set(converted))
    if missing:
        raise KeyError(f"missing keys for port {what} {missing}")
    for name, arr in converted.items():
        if arr.shape != tuple(targets[name].shape):
            raise ValueError(
                f"shape mismatch for {name}: {arr.shape} vs {tuple(targets[name].shape)}"
            )
    return converted


def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                    batch_stats: Optional[Mapping[str, np.ndarray]] = None) -> nn.Module:
    """Fill every parameter of ``model`` from a JAX flat param dict (the
    unrolled or the ``scan_layers`` layout) and, when ``batch_stats`` (the
    JAX ``batch_stats`` collection, flat) is given, every BatchNorm running
    statistic from it.  A laid-out model (``model.layout``) keeps each
    rank's pieces of the full arrays, a pipeline stage's rank its stage's
    blocks of them."""
    params, buffers = dict(model.named_parameters()), dict(model.named_buffers())
    layout = layout_of(model)
    shapes = params if layout is None else {
        n: torch.empty(place.full_shape, device="meta") for n, place in layout.placements.items()}
    loads = [(params, _convert(flat, shapes, "parameters"))]
    if batch_stats is not None:
        loads.append((buffers, _convert(batch_stats, buffers, "buffers")))
    with torch.no_grad():
        for targets, arrays in loads:
            for name, arr in arrays.items():
                if name not in targets:  # another pipeline stage's block
                    continue
                value = torch.from_numpy(arr)
                if layout is not None and name in layout.placements:
                    value = layout.local(name, value)
                targets[name].copy_(value)
    return model


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load an ``.npz`` written by the JAX package's ``save_weights``."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    with np.load(path) as data:
        return load_jax_params(model, {k: data[k] for k in data.files})


def _dense_inv(a):
    return a.T  # an ndarray's or a 2-D tensor's


def _conv_inv(a):
    # OIHW → HWIO, of an ndarray or a tensor
    return a.permute(2, 3, 1, 0) if isinstance(a, torch.Tensor) else a.transpose(2, 3, 1, 0)


def _jax_module_path(mod_name: str, resnet: bool) -> List[str]:
    """A port module name → the JAX module path parts: the inverse of
    :func:`torch_name`'s module renames (the ResNet ones only in a ResNet
    tower, whose ``visual.conv1`` is the stem's where a ViT's is the patch
    conv)."""
    name = re.sub(r"resblocks\.(\d+)", r"resblock_\1", mod_name)
    if resnet:
        name = re.sub(r"^visual\.((?:conv|bn)\d+)$", r"visual.stem_\1", name)
        name = re.sub(r"(layer\d+)\.(\d+)", r"\1_block\2", name)
        name = re.sub(r"downsample\.0$", "downsample_conv", name)
        name = re.sub(r"downsample\.1$", "downsample_bn", name)
    return [p for p in name.split(".") if p]


def jax_paths(model: nn.Module) -> Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]]:
    """Port parameter name → (JAX flat path, array layout transform): the
    inverse of :func:`torch_name`, by module type.  Parameters only: the
    BatchNorm running statistics are buffers, outside the JAX ``params``."""
    from sparsify_clip_tpu_torch.models.layers import LayerNorm
    from sparsify_clip_tpu_torch.models.resnet import BatchNormHalf, ModifiedResNet

    resnet = isinstance(getattr(model, "visual", None), ModifiedResNet)
    out = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            parts = _jax_module_path(mod_name, resnet)
            fn = _identity
            if isinstance(module, LayerNorm):
                parts += ["ln", "scale" if p_name == "weight" else p_name]
            elif isinstance(module, BatchNormHalf):
                parts.append("scale" if p_name == "weight" else p_name)
            elif p_name == "in_proj_weight":
                parts, fn = parts + ["in_proj", "kernel"], _dense_inv
            elif p_name == "in_proj_bias":
                parts += ["in_proj", "bias"]
            elif isinstance(module, nn.Conv2d) and p_name == "weight":
                parts, fn = parts + ["kernel"], _conv_inv
            elif isinstance(module, nn.Linear) and p_name == "weight":
                parts, fn = parts + ["kernel"], _dense_inv
            elif not isinstance(module, nn.Embedding):  # token_embedding: the table itself
                parts.append(p_name)
            path = "/".join(parts)
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if torch_name(path)[0] != name:
                raise AssertionError(f"no JAX path for {name}: {path} maps back to "
                                     f"{torch_name(path)[0]}")
            out[name] = (path, fn)
    return out


def full_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters at full shape by name: a laid-out model's
    put together (a collective), else the parameters themselves."""
    layout = layout_of(model)
    return dict(model.named_parameters()) if layout is None else layout.full_params(model)


def collect_host_arrays(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as the JAX flat dict ``{slash/path: fp32
    ndarray}``, in the JAX layouts, at full shape (a collective for a
    laid-out model), the trunks stacked as ``layers_scan`` for a model
    built with ``scan_layers``."""
    params = full_parameters(model)
    layout = layout_of(model)
    names = layout.one_process if layout is not None and layout.pipeline else model
    # the layout transforms and the stacks run on the tensors' device, and
    # each array leaves it once: on the host, a 1.4 B-parameter tower's
    # transposes alone took 13 s
    flat = {path: fn(params[name].detach().float())
            for name, (path, fn) in jax_paths(names).items()}
    if getattr(model, "knobs", {}).get("scan_layers"):
        flat = stack_scan_layers(flat)
    return {path: t.contiguous().cpu().numpy() for path, t in flat.items()}


def collect_variables(model: nn.Module) -> Dict[str, np.ndarray]:
    """The JAX variables dict of the model, flattened with "/": the
    parameters under ``params/`` (:func:`collect_host_arrays`) and, for a
    ResNet tower, the BatchNorm running statistics under ``batch_stats/``
    (``<module path>/mean`` and ``/var``), fp32, as the JAX
    ``save_weights(variables, ...)`` writes them (export.py:178-186)."""
    from sparsify_clip_tpu_torch.models.resnet import BatchNormHalf, ModifiedResNet

    resnet = isinstance(getattr(model, "visual", None), ModifiedResNet)
    out = {f"params/{path}": arr for path, arr in collect_host_arrays(model).items()}
    for mod_name, module in model.named_modules():
        if isinstance(module, BatchNormHalf):
            path = "/".join(_jax_module_path(mod_name, resnet))
            for leaf, buf in (("mean", module.running_mean), ("var", module.running_var)):
                out[f"batch_stats/{path}/{leaf}"] = buf.detach().float().cpu().numpy()
    return out


def save_weights(model: nn.Module, path: str) -> str:
    """Weights-only ``.npz`` under the JAX flat keys (the reference's
    periodic ``torch.save(model.state_dict())``), readable by the JAX
    ``load_weights`` and by :func:`load_weights`."""
    path = os.path.abspath(os.path.expanduser(path))
    if is_primary() or layout_of(model) is not None:  # every rank gathers a laid-out one
        arrays = collect_host_arrays(model)
    if is_primary():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **arrays)
    barrier()
    return path


# ---------------------------------------------------------------- full state


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor detached and copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _snapshot(state, config: Optional[Any] = None) -> Dict[str, Any]:
    """The full state on the host; a laid-out model's put together first
    (a collective)."""
    layout = layout_of(state.model)
    if layout is None:
        model, optimizer = state.model.state_dict(), state.optimizer.state_dict()
    else:
        model = layout.full_state_dict(state.model)
        optimizer = full_optimizer_state(state, layout)
    return {
        "step": int(state.step),
        "model": _to_host(model),
        "optimizer": _to_host(optimizer),
        "temperature": _to_host(state.temperature),
        "loss_scalars": _to_host(state.loss_scalars),
        "aug_generator": (None if state.aug_generator is None
                          else state.aug_generator.get_state()),
        "config": config.to_dict() if config is not None else None,
    }


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(os.path.expanduser(directory)), f"step_{step}.pt")


def _write(payload: Dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_full(state, directory: str, config: Optional[Any] = None) -> str:
    """Save the full TrainState (model parameters and running statistics,
    AdamW and its moments in their dtypes, temperature, SigLIP's loss
    scalars, the device-augment generator's state, step) and the config as
    ``directory/step_<N>.pt``."""
    path = _step_path(directory, int(state.step))
    if is_primary() or layout_of(state.model) is not None:  # every rank gathers a laid-out one
        payload = _snapshot(state, config)
    if is_primary():
        _write(payload, path)
    barrier()
    return path


_async_saves: List[threading.Thread] = []
_async_errors: List[BaseException] = []


def save_full_async(state, directory: str, config: Optional[Any] = None) -> str:
    """Non-blocking :func:`save_full`: the state is copied to host memory
    now, and a thread writes the file, so the train loop keeps stepping.
    Call :func:`wait_for_async_saves` before reading the files or exiting."""
    path = _step_path(directory, int(state.step))
    if is_primary() or layout_of(state.model) is not None:  # every rank gathers a laid-out one
        payload = _snapshot(state, config)
    if not is_primary():
        return path

    def write():
        try:
            _write(payload, path)
        except BaseException as exc:  # re-raised by wait_for_async_saves
            _async_errors.append(exc)

    thread = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
    thread.start()
    _async_saves.append(thread)
    return path


def wait_for_async_saves() -> None:
    """Block until every :func:`save_full_async` has written its file;
    re-raise the first error of one that failed."""
    while _async_saves:
        _async_saves.pop(0).join()
    barrier()
    if _async_errors:
        exc = _async_errors[0]
        _async_errors.clear()
        raise RuntimeError("an asynchronous checkpoint failed") from exc


def _steps(directory: str) -> List[Tuple[int, str]]:
    path = os.path.abspath(os.path.expanduser(directory))
    if not os.path.isdir(path):
        return []
    found = []
    for name in os.listdir(path):
        stem, ext = os.path.splitext(name)
        if ext == ".pt" and stem.startswith("step_") and stem[5:].isdigit():
            found.append((int(stem[5:]), os.path.join(path, name)))
    return sorted(found)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1][0] if steps else None


def restore_full(directory_or_path: str, state):
    """Restore a :func:`save_full` checkpoint into ``state`` (a TrainState
    of the same model and optimizer, e.g. a fresh one, in any layout) in
    place, and return it.  A directory restores its latest step."""
    path = os.path.abspath(os.path.expanduser(directory_or_path))
    if os.path.isdir(path):
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no step_*.pt checkpoints under {path}")
        path = steps[-1][1]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    layout = layout_of(state.model)
    if layout is None:
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
    else:  # each rank keeps its pieces of the full state
        layout.load_state_dict(state.model, payload["model"])
        load_optimizer_state(state, layout, payload["optimizer"])
    with torch.no_grad():
        state.temperature.copy_(payload["temperature"])
        for name, value in (payload.get("loss_scalars") or {}).items():
            state.loss_scalars[name].copy_(value)
    if payload.get("aug_generator") is not None and state.aug_generator is not None:
        state.aug_generator.set_state(payload["aug_generator"])
    state.step = int(payload["step"])
    return state
