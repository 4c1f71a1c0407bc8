"""One gloo rank of tests/test_torch_port_large_towers.py's layout runs:
tests/torch_dp_worker.py's rank with the narrow twins of ViT-H-14,
ViT-g-14 and ViT-bigG-14 in the port's registry.

    python tests/test_torch_port_large_towers_rank.py <job> <plan.json> <out_dir>

It imports torch, numpy and the port only; it holds no test.
"""

import sys

# each vision tower's head_dim (80, 88, 104) and MLP ratio and each text
# tower's head_dim (64) at 2 heads and 2 blocks, at the layouts harness's
# 32 px (in 16 px patches), 12 tokens and vocab of 256 (tests/torch_layouts.py)
_TWIN = dict(vision_kind="vit", image_size=32, vision_layers=(2,), vision_heads=2,
             patch_size=16, vocab_size=256, context_length=12, text_width=128, text_heads=2,
             text_layers=2)
TWINS = {
    "h14-twin": dict(_TWIN, name="h14-twin", embed_dim=1024, vision_width=160),
    "g14-twin": dict(_TWIN, name="g14-twin", embed_dim=1024, vision_width=176,
                     vision_mlp_hidden=768),
    "bigG-twin": dict(_TWIN, name="bigG-twin", embed_dim=1280, vision_width=208,
                      vision_mlp_hidden=1024),
}


def register_twins(registry: dict, config_class) -> None:
    for name, fields in TWINS.items():
        registry.setdefault(name, config_class(**fields))


if __name__ == "__main__":
    import torch_dp_worker  # beside this file, on the script's path

    from sparsify_clip_tpu_torch.models import clip

    register_twins(clip.MODEL_REGISTRY, clip.CLIPConfig)
    torch_dp_worker.main(*sys.argv[1:4])
