"""Two-tower CLIP and the model-name registry, ported from
:mod:`sparsify_clip_tpu.models.clip`.

``CLIPConfig`` and ``MODEL_REGISTRY`` are copies of the JAX package's
(clip.py:31-137): importing them from there would import JAX.  As on
the JAX side, the learnable temperature is not a model parameter.

Parameter names are open_clip's, with the text tower under ``text.``
(open_clip's ``CustomTextCLIP`` layout; a standard open_clip ``CLIP``
keeps those keys at the top level).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from sparsify_clip_tpu_torch.models.layers import LayerNorm, gelu_exact, quick_gelu
from sparsify_clip_tpu_torch.models.text import TextTransformer
from sparsify_clip_tpu_torch.models.vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    # vision tower
    vision_kind: str  # "resnet" | "vit"
    image_size: int = 224
    vision_width: int = 64        # resnet: stem width; vit: transformer width
    vision_layers: Tuple[int, ...] = (3, 4, 6, 3)  # resnet stages or (depth,) for vit
    vision_heads: int = 32        # resnet: attnpool heads; vit: attention heads
    patch_size: int = 32          # vit only
    # Non-4x MLP hidden widths (LAION ViT-g/bigG); None → width*4.
    vision_mlp_hidden: Optional[int] = None
    text_mlp_hidden: Optional[int] = None
    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    quick_gelu: bool = False


MODEL_REGISTRY: Dict[str, CLIPConfig] = {
    "RN50": CLIPConfig(
        name="RN50", embed_dim=1024, vision_kind="resnet",
        vision_width=64, vision_layers=(3, 4, 6, 3), vision_heads=32,
    ),
    "RN101": CLIPConfig(
        name="RN101", embed_dim=512, vision_kind="resnet",
        vision_width=64, vision_layers=(3, 4, 23, 3), vision_heads=32,
    ),
    "RN50x4": CLIPConfig(
        name="RN50x4", embed_dim=640, vision_kind="resnet", image_size=288,
        vision_width=80, vision_layers=(4, 6, 10, 6), vision_heads=40,
        text_width=640, text_heads=10, text_layers=12,
    ),
    "RN50x16": CLIPConfig(
        name="RN50x16", embed_dim=768, vision_kind="resnet", image_size=384,
        vision_width=96, vision_layers=(6, 8, 18, 8), vision_heads=48,
        text_width=768, text_heads=12, text_layers=12,
    ),
    "ViT-B-32": CLIPConfig(
        name="ViT-B-32", embed_dim=512, vision_kind="vit",
        vision_width=768, vision_layers=(12,), vision_heads=12, patch_size=32,
    ),
    "ViT-B-16": CLIPConfig(
        name="ViT-B-16", embed_dim=512, vision_kind="vit",
        vision_width=768, vision_layers=(12,), vision_heads=12, patch_size=16,
    ),
    "RN50x64": CLIPConfig(
        name="RN50x64", embed_dim=1024, vision_kind="resnet", image_size=448,
        vision_width=128, vision_layers=(3, 15, 36, 10), vision_heads=64,
        text_width=1024, text_heads=16, text_layers=12,
    ),
    "ViT-L-14": CLIPConfig(
        name="ViT-L-14", embed_dim=768, vision_kind="vit",
        vision_width=1024, vision_layers=(24,), vision_heads=16, patch_size=14,
        text_width=768, text_heads=12, text_layers=12,
    ),
    "ViT-L-14-336": CLIPConfig(
        name="ViT-L-14-336", embed_dim=768, vision_kind="vit", image_size=336,
        vision_width=1024, vision_layers=(24,), vision_heads=16, patch_size=14,
        text_width=768, text_heads=12, text_layers=12,
    ),
    "ViT-H-14": CLIPConfig(
        name="ViT-H-14", embed_dim=1024, vision_kind="vit",
        vision_width=1280, vision_layers=(32,), vision_heads=16, patch_size=14,
        text_width=1024, text_heads=16, text_layers=24,
    ),
    "ViT-g-14": CLIPConfig(
        name="ViT-g-14", embed_dim=1024, vision_kind="vit",
        vision_width=1408, vision_layers=(40,), vision_heads=16,
        patch_size=14, vision_mlp_hidden=6144,
        text_width=1024, text_heads=16, text_layers=24,
    ),
    "ViT-bigG-14": CLIPConfig(
        name="ViT-bigG-14", embed_dim=1280, vision_kind="vit",
        vision_width=1664, vision_layers=(48,), vision_heads=16,
        patch_size=14, vision_mlp_hidden=8192,
        text_width=1280, text_heads=20, text_layers=32,
    ),
    # seconds-scale smoke model (full vocab and context, tiny towers)
    "tiny-test": CLIPConfig(
        name="tiny-test", embed_dim=16, vision_kind="vit", image_size=32,
        vision_width=32, vision_layers=(2,), vision_heads=2, patch_size=16,
        vocab_size=49408, context_length=77, text_width=16, text_heads=2,
        text_layers=2,
    ),
}
# OpenAI-parameterized (QuickGELU) variants, open_clip's "<name>-quickgelu".
for _base in ["RN50", "RN101", "ViT-B-32", "ViT-B-16", "ViT-L-14",
              "ViT-L-14-336"]:
    _cfg = MODEL_REGISTRY[_base]
    MODEL_REGISTRY[f"{_base}-quickgelu"] = dataclasses.replace(
        _cfg, name=f"{_base}-quickgelu", quick_gelu=True
    )


class CLIP(nn.Module):
    """Two-tower CLIP returning **unnormalized** embeddings; callers
    L2-normalize.  ViT vision towers only (ResNet towers: ROADMAP).
    ``fused_ln_qkv`` runs every block's ln_1 and in_proj as the fused
    LN+qkv kernel, as the JAX ``CLIP(fused_ln_qkv=True)``."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 fused_ln_qkv: bool = False):
        super().__init__()
        if cfg.vision_kind != "vit":
            raise NotImplementedError(
                f"{cfg.name}: the ResNet vision tower is not ported yet "
                "(ROADMAP Queue 1, 'ResNet family')"
            )
        self.cfg = cfg
        self.fused_ln_qkv = fused_ln_qkv
        act = quick_gelu if cfg.quick_gelu else gelu_exact
        self.visual = VisionTransformer(
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            width=cfg.vision_width, layers=cfg.vision_layers[0],
            heads=cfg.vision_heads, mlp_hidden=cfg.vision_mlp_hidden,
            embed_dim=cfg.embed_dim, act=act, dtype=dtype, fused_ln_qkv=fused_ln_qkv,
        )
        self.text = TextTransformer(
            vocab_size=cfg.vocab_size, context_length=cfg.context_length,
            width=cfg.text_width, heads=cfg.text_heads, layers=cfg.text_layers,
            mlp_hidden=cfg.text_mlp_hidden, embed_dim=cfg.embed_dim, act=act, dtype=dtype,
            fused_ln_qkv=fused_ln_qkv,
        )

    @property
    def dtype(self) -> torch.dtype:
        """The compute type (LayerNorm computes in fp32 whatever it is)."""
        return self.visual.dtype

    @property
    def device(self) -> torch.device:
        return self.visual.proj.device

    def with_dtype(self, dtype: torch.dtype) -> "CLIP":
        """A CLIP that computes in ``dtype`` over this model's parameters:
        the same ``Parameter`` objects, not copies, so it sees every update
        to them (the JAX side's ``model.clone(dtype=...)`` applied to the
        shared params), with this model's ``fused_ln_qkv``."""
        with torch.device("meta"):
            twin = CLIP(self.cfg, dtype=dtype, fused_ln_qkv=self.fused_ln_qkv)
        twin.load_state_dict(self.state_dict(keep_vars=True), strict=True, assign=True)
        return twin.train(self.training)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.visual.reset_parameters(gen)
        self.text.reset_parameters(gen)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def forward(self, images: torch.Tensor,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode_image(images), self.encode_text(tokens)


def create_model(
    name: str,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    param_dtype: Optional[torch.dtype] = None,
    fused_ln_qkv: bool = False,
) -> CLIP:
    """Build a registry model with fresh weights, in eval mode, on
    ``device`` (the card unless the caller asks for the CPU).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    with the flax modules' initializers (so a seed gives the same model on
    every device).  ``dtype`` is the compute type.  Every weight except
    LayerNorm's is stored in ``param_dtype``, which defaults to ``dtype``:
    a serving model stores its weights once in the compute type, the same
    rounding as the JAX towers' cast at each use.  A training model passes
    ``param_dtype=torch.float32`` and keeps fp32 parameters, cast to
    ``dtype`` where they are used, as on the JAX side.  ``fused_ln_qkv``
    fuses every block's ln_1 into its in_proj (the JAX ``create_model``'s
    knob, clip.py:267); the parameters are the same either way.
    """
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name!r}. Known: {sorted(MODEL_REGISTRY)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"create_model({name!r}) runs on the card by default and no CUDA device "
            "is available; pass device='cpu' to build it on the CPU"
        )
    with torch.device("meta"):
        model = CLIP(MODEL_REGISTRY[name], dtype=dtype, fused_ln_qkv=fused_ln_qkv)
    model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    for module in model.modules():
        if not isinstance(module, LayerNorm):
            for p in module.parameters(recurse=False):
                p.data = p.data.to(param_dtype or dtype)
    return model.to(device).eval()
