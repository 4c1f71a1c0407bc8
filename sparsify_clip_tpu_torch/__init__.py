"""PyTorch/CUDA port of sparsify_clip_tpu, for NVIDIA Hopper.

The JAX package ``sparsify_clip_tpu`` is the reference this package is
held against; this package imports neither JAX nor it.  Ported so far:
the serving path (ViT and ResNet towers, encoder, batching server), the
training step for every loss type (config, schedules, the
uniformity/alignment/centroid losses, the soft-target and sigmoid
losses, loss dispatch with the warm phase, AdamW with an fp32 or bf16
first moment, GradCache accumulation, epoch loop) and the per-epoch eval (13
metrics over an fp32 twin), with hand-written CUDA kernels for the
attention forward and backward, the fused InfoNCE and the fused
uniformity loss; and the training CLI (tokenizer, data loaders, JSONL
logging, checkpoints, exact resume, preemption); the device augment
and raw-uint8 request path, zero-shot classification, the ``encode`` CLI
and ``torch.export`` artifacts (:mod:`sparsify_clip_tpu_torch.export`);
the extensions and knobs: the sparse embedding projection, remat, the
one-hot token embedding, the LayerNorm in the compute type and the
per-eval embedding plots (:mod:`sparsify_clip_tpu_torch.viz`).
See README.md ("PyTorch port").
"""

import importlib

# name → module; imported at first use, so that importing a submodule (the
# custom ops of sparsify_clip_tpu_torch.ops, say, to load an exported
# program) does not import the models, the trainer or the server
_EXPORTS = {
    "CLIP": "models.clip", "CLIPConfig": "models.clip", "MODEL_REGISTRY": "models.clip",
    "create_model": "models.clip", "CLIPEncoder": "inference", "RetrievalIndex": "inference",
    "BatchingEncoderServer": "serving", "ServerStats": "serving", "bucket_ladder": "serving",
    "load_jax_params": "checkpoints", "load_weights": "checkpoints",
    "TrainSetup": "train", "TrainState": "train", "create_train_setup": "train",
    "run_training": "train", "ExportedEncoder": "export",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
