"""PyTorch/CUDA port of sparsify_clip_tpu, for NVIDIA Hopper.

The JAX package ``sparsify_clip_tpu`` is the reference this package is
held against; this package imports neither JAX nor it.  Ported so far:
the serving path (ViT towers, encoder, batching server) with a
hand-written CUDA attention kernel.  See README.md ("PyTorch port").
"""

from sparsify_clip_tpu_torch.checkpoints import load_jax_params, load_weights
from sparsify_clip_tpu_torch.inference import CLIPEncoder, RetrievalIndex
from sparsify_clip_tpu_torch.models.clip import CLIP, MODEL_REGISTRY, CLIPConfig, create_model
from sparsify_clip_tpu_torch.serving import BatchingEncoderServer, ServerStats, bucket_ladder

__all__ = [
    "CLIP", "CLIPConfig", "CLIPEncoder", "MODEL_REGISTRY", "BatchingEncoderServer",
    "RetrievalIndex", "ServerStats", "bucket_ladder", "create_model",
    "load_jax_params", "load_weights",
]
