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
from sparsify_clip_tpu_torch.models.resnet import BatchNormHalf, ModifiedResNet
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
    L2-normalize.  The vision tower is a ViT or, for the RN registry
    entries, a :class:`ModifiedResNet`, whose BatchNorms use the batch
    statistics in train mode and the running statistics in eval mode (the
    JAX ``CLIP(..., train=True/False)``).  The knobs are the JAX
    ``CLIP``'s (clip.py:147-166): ``fused_ln_qkv`` runs every transformer
    block's ln_1 and in_proj as the fused LN+qkv kernel; ``remat`` and
    ``remat_policy`` recompute each block (a ``Bottleneck`` in a ResNet)
    in every tower's backward; ``ln_fp32: False`` gives the blocks flax's
    LayerNorm in the compute type (and the unfused route); ``onehot_embed``
    embeds the tokens by a one-hot product; ``scan_layers`` writes the
    weight files in the JAX stacked layout (a name layout, no other
    effect); ``pipeline_stages`` S > 1 makes each transformer trunk this
    rank's stage of a GPipe pipeline over ``mesh``'s model axis, of
    ``pipeline_microbatches`` microbatches (the JAX ``CLIP``'s
    ``pipeline_*`` fields, clip.py:167-187; a ViT vision tower alone)."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 fused_ln_qkv: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = None, ln_fp32: bool = True,
                 onehot_embed: bool = False, scan_layers: bool = False,
                 pipeline_stages: int = 1, pipeline_microbatches: Optional[int] = None,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.knobs = dict(fused_ln_qkv=fused_ln_qkv, remat=remat, remat_policy=remat_policy,
                          ln_fp32=ln_fp32, onehot_embed=onehot_embed, scan_layers=scan_layers,
                          pipeline_stages=pipeline_stages,
                          pipeline_microbatches=pipeline_microbatches, mesh=mesh)
        act = quick_gelu if cfg.quick_gelu else gelu_exact
        blocks = dict(remat=remat, remat_policy=remat_policy)
        pipeline = dict(scan_layers=scan_layers, pipeline_stages=pipeline_stages,
                        pipeline_microbatches=pipeline_microbatches, mesh=mesh)
        if pipeline_stages > 1 and cfg.vision_kind != "vit":
            raise ValueError(
                "pipeline_stages > 1 pipelines transformer block stacks; "
                f"the {cfg.name} vision tower is a ResNet (stage-"
                "heterogeneous blocks) — use TP (mesh_model) or FSDP instead"
            )
        if cfg.vision_kind == "resnet":
            self.visual = ModifiedResNet(
                layers=cfg.vision_layers, width=cfg.vision_width, image_size=cfg.image_size,
                embed_dim=cfg.embed_dim, heads=cfg.vision_heads, dtype=dtype, **blocks,
            )
        elif cfg.vision_kind == "vit":
            self.visual = VisionTransformer(
                image_size=cfg.image_size, patch_size=cfg.patch_size,
                width=cfg.vision_width, layers=cfg.vision_layers[0],
                heads=cfg.vision_heads, mlp_hidden=cfg.vision_mlp_hidden,
                embed_dim=cfg.embed_dim, act=act, dtype=dtype, fused_ln_qkv=fused_ln_qkv,
                ln_fp32=ln_fp32, **blocks, **pipeline,
            )
        else:
            raise ValueError(f"Unknown vision_kind {cfg.vision_kind}")
        self.text = TextTransformer(
            vocab_size=cfg.vocab_size, context_length=cfg.context_length,
            width=cfg.text_width, heads=cfg.text_heads, layers=cfg.text_layers,
            mlp_hidden=cfg.text_mlp_hidden, embed_dim=cfg.embed_dim, act=act, dtype=dtype,
            fused_ln_qkv=fused_ln_qkv, ln_fp32=ln_fp32, onehot_embed=onehot_embed, **blocks,
            **pipeline,
        )

    @property
    def fused_ln_qkv(self) -> bool:
        return self.knobs["fused_ln_qkv"]

    @property
    def one_process_knobs(self) -> dict:
        """The knobs of this model on one process: the pipeline's off."""
        return dict(self.knobs, pipeline_stages=1, pipeline_microbatches=None, mesh=None)

    @property
    def dtype(self) -> torch.dtype:
        """The compute type (LayerNorm computes in fp32 whatever it is)."""
        return self.visual.dtype

    @property
    def device(self) -> torch.device:
        return self.text.positional_embedding.device

    def with_dtype(self, dtype: torch.dtype) -> "CLIP":
        """A CLIP that computes in ``dtype`` over this model's parameters
        and buffers: the same tensors, not copies, so it sees every update
        to them (the JAX side's ``model.clone(dtype=...)`` applied to the
        shared params and batch_stats), with this model's knobs (a
        pipelined model's twin is the same stage of the same pipeline)."""
        with torch.device("meta"):
            twin = CLIP(self.cfg, dtype=dtype, **self.knobs)
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
    image_size: Optional[int] = None,
    remat: bool = False,
    remat_policy: Optional[str] = None,
    ln_fp32: bool = True,
    onehot_embed: bool = False,
    scan_layers: bool = False,
    pipeline_stages: int = 1,
    pipeline_microbatches: Optional[int] = None,
    mesh=None,
) -> CLIP:
    """Build a registry model with fresh weights, in eval mode, on
    ``device`` (the card unless the caller asks for the CPU).

    Weights are drawn on ``device`` from ``torch.Generator(device).
    manual_seed(seed)`` with the flax modules' initializers: a seed gives
    the same model on every card and on every layout, and another one on
    the CPU (the card's Philox stream is not the CPU's).  Drawing on the
    card keeps a 1-2.5 B-parameter tower's draws off the host (the CPU
    draws about 125 M values a second) and its fp32 copy off the link.
    ``dtype`` is the compute type.  Every weight except
    LayerNorm's and BatchNorm's is stored in ``param_dtype``, which
    defaults to ``dtype``: a serving model stores its weights once in the
    compute type, the same rounding as the JAX towers' cast at each use.
    BatchNorm's scale, bias and running statistics stay fp32, as the JAX
    side casts ``inv`` and ``shift`` at use, and so do the 1×1 kernels a
    BatchNorm folds into (``ModifiedResNet.folded_convs``): the JAX side
    folds the fp32 kernel and rounds the product once (resnet.py:332-334).  A training model passes
    ``param_dtype=torch.float32`` and keeps fp32 parameters, cast to
    ``dtype`` where they are used, as on the JAX side.  ``fused_ln_qkv``
    fuses every block's ln_1 into its in_proj (the JAX ``create_model``'s
    knob, clip.py:267); the parameters are the same either way, and under
    ``remat``, ``remat_policy``, ``ln_fp32`` and ``onehot_embed`` (the
    JAX ``create_model``'s knobs of the same names, clip.py:263-286) too.
    ``image_size`` overrides the registry's input resolution (the vision
    tower's positional embedding follows it), as the JAX ``create_model``'s.
    ``scan_layers``, ``pipeline_stages``, ``pipeline_microbatches`` and
    ``mesh`` are :class:`CLIP`'s: a pipelined model keeps this rank's
    stage of each trunk, whose weights are those of the whole model drawn
    from ``seed``.
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
        cfg = MODEL_REGISTRY[name]
        if image_size is not None:
            cfg = dataclasses.replace(cfg, image_size=image_size)
        model = CLIP(cfg, dtype=dtype, fused_ln_qkv=fused_ln_qkv, remat=remat,
                     remat_policy=remat_policy, ln_fp32=ln_fp32, onehot_embed=onehot_embed,
                     scan_layers=scan_layers, pipeline_stages=pipeline_stages,
                     pipeline_microbatches=pipeline_microbatches, mesh=mesh)
    model.to_empty(device=device)
    model.reset_parameters(torch.Generator(device).manual_seed(seed))
    folded = model.visual.folded_convs() if isinstance(model.visual, ModifiedResNet) else ()
    for module in model.modules():
        if not isinstance(module, (LayerNorm, BatchNormHalf)) and module not in folded:
            for p in module.parameters(recurse=False):
                p.data = p.data.to(param_dtype or dtype)
    return model.eval()
