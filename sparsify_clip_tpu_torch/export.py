"""Deployment export: serialized, self-contained encoder artifacts, ported
from :mod:`sparsify_clip_tpu.export` onto ``torch.export``.

* An artifact is two programs, ``image_encoder.pt2`` and
  ``text_encoder.pt2`` (``torch.export.save``), and ``export_meta.json``.
  A serving host loads them with :class:`ExportedEncoder` and needs
  ``torch`` and this package's custom ops, not the model code, the
  config or the weights' source.
* The programs carry the kernels: the towers' attention forwards (and,
  with ``fused_ln_qkv``, the fused LN+qkv) are ``torch.library`` custom
  ops (:mod:`sparsify_clip_tpu_torch.ops`), which ``torch.export`` records
  as calls.  A loaded program dispatches each call by device: the kernel
  on a CUDA tensor (or a raised error), the plain version on a CPU tensor.
  A symbolic batch needs no other route: the ops' fake implementations
  give the output shapes under it (the JAX package's symbolic export falls
  back to XLA attention instead, export.py:139-149).
* ``batch=None`` (the default) exports a symbolic batch dimension, 1 to
  65535 (the attention kernels' grid limit); an int pins it.
* ``bake_params=True`` keeps the weights inside each program.
  ``bake_params=False`` exports programs that take the model's parameters
  and buffers, a dict by name, as their first argument, and writes them
  once to ``weights.npz`` in the JAX ``save_exported`` layout (the
  ``/``-joined variables: ``params/...`` and, for a ResNet,
  ``batch_stats/...``), which each package's loader reads.
* ``uint8_input=True`` bakes the CLIP normalization into the image
  program: it takes raw (B, H, W, 3) uint8.
* A program runs on the device it was traced on, the model's (the CLI's
  ``--device``): the ``platforms`` parameter (a JAX notion) may name that
  device type, ``"cuda"`` or ``"cpu"``, and nothing else.
* Outputs are :class:`~sparsify_clip_tpu_torch.inference.CLIPEncoder`'s
  contract: L2-normalized fp32 embeddings.

CLI::

    python -m sparsify_clip_tpu_torch.export \\
        --model ViT-B-32 --weights models/run.npz --out exported/vitb32 \\
        [--batch 64] [--device cuda|cpu] [--no-bake-params] [--uint8-input]
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

import sparsify_clip_tpu_torch.ops  # noqa: F401  (registers the kernels' custom ops)
from sparsify_clip_tpu_torch.checkpoints import torch_name
from sparsify_clip_tpu_torch.ops.image import normalize_batch
from sparsify_clip_tpu_torch.utils.numerics import l2_normalize

_IMAGE_FILE = "image_encoder.pt2"
_TEXT_FILE = "text_encoder.pt2"
_META_FILE = "export_meta.json"
_WEIGHTS_FILE = "weights.npz"
MAX_BATCH = 65535  # the attention kernels' grid limit on the batch
PLATFORMS = ("cuda", "cpu")


class _ImageProgram(nn.Module):
    """Pixels → unit fp32 embeddings; raw uint8 pixels normalized first
    with ``uint8_input``."""

    def __init__(self, model, uint8_input: bool):
        super().__init__()
        self.model = model
        self.uint8_input = uint8_input

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.uint8_input:
            images = normalize_batch(images.float() / 255.0)
        return l2_normalize(self.model.encode_image(images))


class _TextProgram(nn.Module):
    """Token rows → unit fp32 embeddings."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.model.encode_text(tokens))


class _Unbaked(nn.Module):
    """A program whose first argument is the model's parameters and
    buffers by name.  The wrapped program is kept outside the module tree,
    so the exported program holds no weights of its own."""

    def __init__(self, program: nn.Module):
        super().__init__()
        self._program = (program,)

    def forward(self, variables: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        named = {f"model.{name}": value for name, value in variables.items()}
        return torch.func.functional_call(self._program[0], named, (x,), strict=True)


def check_platforms(platforms: Optional[Sequence[str]], device: torch.device) -> list:
    """The artifact's platforms: ``[device.type]``.  An explicit list must
    name that device type alone: a ``torch.export`` program runs on the
    device it was traced on, and the port runs on ``cuda`` or ``cpu``."""
    if platforms is None:
        return [device.type]
    names = [p.lower() for p in platforms]
    foreign = [p for p in names if p not in PLATFORMS]
    if foreign:
        raise ValueError(
            f"platforms {foreign}: the port exports for {list(PLATFORMS)} only "
            "(tpu and the other platforms are jax.export's)")
    if names != [device.type]:
        raise ValueError(
            f"platforms {names}: a torch.export program runs on the device it was "
            f"traced on, and this model is on {device.type}; build the model on the "
            "target device and export one artifact a device")
    return names


def export_encoders(model, batch: Optional[int] = None,
                    platforms: Optional[Sequence[str]] = None, bake_params: bool = True,
                    uint8_input: bool = False) -> Dict[str, "torch.export.ExportedProgram"]:
    """Export both towers of ``model`` (a :class:`CLIP` in its compute
    type, on its device) → ``{"image": ExportedProgram, "text":
    ExportedProgram}``.  A model in train mode is exported through its
    eval twin (the same tensors), as :class:`CLIPEncoder` encodes.  The
    tracing runs without autograd, so each forward is its custom op."""
    device = model.device
    check_platforms(platforms, device)
    if model.training:
        model = model.with_dtype(model.dtype).eval()
    cfg = model.cfg
    n = 2 if batch is None else int(batch)  # 2: a 1 would be specialized
    images = torch.zeros((n, cfg.image_size, cfg.image_size, 3),
                         dtype=torch.uint8 if uint8_input else torch.float32, device=device)
    tokens = torch.zeros((n, cfg.context_length), dtype=torch.int32, device=device)
    dims = {0: torch.export.Dim("batch", min=1, max=MAX_BATCH)} if batch is None else None
    programs = {"image": (_ImageProgram(model, uint8_input), images),
                "text": (_TextProgram(model), tokens)}
    exported = {}
    with torch.no_grad():
        for kind, (program, x) in programs.items():
            if bake_params:
                args, shapes = (x,), (dims,)
            else:
                variables = {**dict(model.named_parameters()), **dict(model.named_buffers())}
                program = _Unbaked(program)
                args = ({k: v.detach() for k, v in variables.items()}, x)
                shapes = ({k: None for k in variables}, dims)
            exported[kind] = torch.export.export(program, args, dynamic_shapes=shapes,
                                                 strict=False)
    return exported


def save_exported(model, out_dir: str, model_name: Optional[str] = None,
                  batch: Optional[int] = None, platforms: Optional[Sequence[str]] = None,
                  bake_params: bool = True, uint8_input: bool = False) -> str:
    """Export and serialize both towers under ``out_dir``:
    ``image_encoder.pt2``, ``text_encoder.pt2`` and ``export_meta.json``;
    with ``bake_params=False`` also ``weights.npz`` (fp32, the JAX
    variables layout) and the programs' variable names and types in the
    meta."""
    from sparsify_clip_tpu_torch.checkpoints import collect_variables

    exported = export_encoders(model, batch=batch, platforms=platforms,
                               bake_params=bake_params, uint8_input=uint8_input)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported["image"], os.path.join(out_dir, _IMAGE_FILE))
    torch.export.save(exported["text"], os.path.join(out_dir, _TEXT_FILE))
    cfg = model.cfg
    meta = {
        "model": model_name or cfg.name,
        "image_size": cfg.image_size,
        "context_length": cfg.context_length,
        "embed_dim": cfg.embed_dim,
        "batch": batch,  # null = symbolic (any batch size)
        "baked_params": bake_params,
        "uint8_input": uint8_input,
        "platforms": check_platforms(platforms, model.device),
        "device": str(model.device),
        "torch_version": torch.__version__,
        "output": "L2-normalized fp32 embeddings",
    }
    if not bake_params:
        np.savez(os.path.join(out_dir, _WEIGHTS_FILE), **collect_variables(model))
        tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        meta["variables"] = [[name, str(t.dtype).split(".")[1]] for name, t in tensors.items()]
    with open(os.path.join(out_dir, _META_FILE), "w") as fh:
        json.dump(meta, fh, indent=1)
    return out_dir


def _load_variables(path: str, names_and_dtypes, device) -> Dict[str, torch.Tensor]:
    """A ``weights.npz`` in the JAX variables layout → the port's tensors
    by name (in the order and types given), on ``device``."""
    with np.load(path) as data:
        arrays = {}
        for key in data.files:
            name, layout = torch_name(key.split("/", 1)[1])  # drop params/ or batch_stats/
            arrays[name] = np.ascontiguousarray(layout(data[key]))
    missing = [name for name, _ in names_and_dtypes if name not in arrays]
    if missing or len(arrays) != len(names_and_dtypes):
        raise KeyError(f"{path}: missing {missing}, or keys the program does not take")
    return {name: torch.from_numpy(arrays[name]).to(device, getattr(torch, dtype))
            for name, dtype in names_and_dtypes}


class ExportedEncoder:
    """Serving-side loader for a :func:`save_exported` directory: runs the
    deserialized programs, with no model code and no config (pass a
    tokenizer only for :meth:`encode_texts` on raw strings).

    The programs run on the device they were exported on (``meta
    ["device"]``), under ``torch.inference_mode()``; there the attention
    calls launch the CUDA kernels, or run the plain versions on the
    CPU."""

    def __init__(self, directory: str, tokenizer=None):
        with open(os.path.join(directory, _META_FILE)) as fh:
            self.meta = json.load(fh)
        self.device = torch.device(self.meta["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{directory} was exported for {self.device} and no CUDA "
                               "device is available")
        self._image = torch.export.load(os.path.join(directory, _IMAGE_FILE)).module()
        self._text = torch.export.load(os.path.join(directory, _TEXT_FILE)).module()
        self._variables = None
        if not self.meta["baked_params"]:
            self._variables = _load_variables(os.path.join(directory, _WEIGHTS_FILE),
                                             self.meta["variables"], self.device)
        self.tokenizer = tokenizer

    def _run(self, program, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if self._variables is not None:
                return program(self._variables, x)
            return program(x)

    def encode_images(self, images) -> torch.Tensor:
        """(B, H, W, 3) pixels → (B, D) unit fp32: normalized float32
        pixels, or raw uint8 where the artifact was exported with
        ``uint8_input`` (``meta["uint8_input"]``)."""
        dtype = torch.uint8 if self.meta["uint8_input"] else torch.float32
        return self._run(self._image, torch.as_tensor(images).to(self.device, dtype))

    def encode_tokens(self, tokens) -> torch.Tensor:
        return self._run(self._text, torch.as_tensor(tokens).to(self.device, torch.int32))

    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("pass a tokenizer to encode raw strings")
        return self.encode_tokens(np.asarray(self.tokenizer(list(texts))))


def main(argv: Optional[Sequence[str]] = None) -> str:
    import argparse

    from sparsify_clip_tpu_torch.checkpoints import load_weights
    from sparsify_clip_tpu_torch.models.clip import create_model

    ap = argparse.ArgumentParser(
        description="Export trained towers as self-contained torch.export artifacts "
                    "(the kernels as custom ops, the weights inside)")
    ap.add_argument("--model", required=True)
    ap.add_argument("--weights", help=".npz from save_weights (random init if omitted)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=None,
                    help="pin a concrete batch size (default: symbolic, any batch)")
    ap.add_argument("--device", default="cuda", choices=PLATFORMS,
                    help="the device the programs are traced on and run on")
    ap.add_argument("--no-bake-params", action="store_true",
                    help="keep the weights out of the programs (weights.npz; the programs "
                         "take them as their first argument)")
    ap.add_argument("--uint8-input", action="store_true",
                    help="the image program takes raw uint8 pixels (normalization inside)")
    args = ap.parse_args(argv)

    model = create_model(args.model, dtype=torch.float32, device=args.device)
    if args.weights:
        load_weights(model, args.weights)
    out = save_exported(
        model, args.out, model_name=args.model, batch=args.batch,
        bake_params=not args.no_bake_params, uint8_input=args.uint8_input,
    )
    print(f"exported {args.model} -> {out}")
    return out


if __name__ == "__main__":
    main()
