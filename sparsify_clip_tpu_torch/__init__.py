"""PyTorch/CUDA port of sparsify_clip_tpu, for NVIDIA Hopper.

The JAX package ``sparsify_clip_tpu`` is the reference this package is
held against; this package imports neither JAX nor it.  Ported so far:
the serving path (ViT towers, encoder, batching server), the training
step for every loss type but ``anchor-roberta`` and ``siglip`` (config,
schedules, the uniformity/alignment/centroid losses, loss dispatch with
the warm phase, AdamW step, epoch loop) and the per-epoch eval (13
metrics over an fp32 twin), with hand-written CUDA kernels for the
attention forward and backward, the fused InfoNCE and the fused
uniformity loss.  See README.md ("PyTorch port").
"""

from sparsify_clip_tpu_torch.checkpoints import load_jax_params, load_weights
from sparsify_clip_tpu_torch.inference import CLIPEncoder, RetrievalIndex
from sparsify_clip_tpu_torch.models.clip import CLIP, MODEL_REGISTRY, CLIPConfig, create_model
from sparsify_clip_tpu_torch.serving import BatchingEncoderServer, ServerStats, bucket_ladder
from sparsify_clip_tpu_torch.train import TrainSetup, TrainState, create_train_setup, run_training

__all__ = [
    "CLIP", "CLIPConfig", "CLIPEncoder", "MODEL_REGISTRY", "BatchingEncoderServer",
    "RetrievalIndex", "ServerStats", "bucket_ladder", "create_model",
    "load_jax_params", "load_weights", "TrainSetup", "TrainState", "create_train_setup",
    "run_training",
]
