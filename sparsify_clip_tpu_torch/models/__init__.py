from sparsify_clip_tpu_torch.models.clip import CLIP, MODEL_REGISTRY, CLIPConfig, create_model

__all__ = ["CLIP", "CLIPConfig", "MODEL_REGISTRY", "create_model"]
