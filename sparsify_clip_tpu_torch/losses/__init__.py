from sparsify_clip_tpu_torch.losses.align import (
    centroid_alignment_loss, lalign_loss, random_alignment_loss,
)
from sparsify_clip_tpu_torch.losses.centroids import (
    compute_centroids, compute_centroids_only, normalized_centroids,
)
from sparsify_clip_tpu_torch.losses.contrastive import contrastive_loss
from sparsify_clip_tpu_torch.losses.dispatch import KNOWN_LOSS_TYPES, LossContext, make_loss_fn
from sparsify_clip_tpu_torch.losses.unif import lunif_loss, pairwise_sq_dists, sparsify_loss

__all__ = [
    "KNOWN_LOSS_TYPES", "LossContext", "centroid_alignment_loss", "compute_centroids",
    "compute_centroids_only", "contrastive_loss", "lalign_loss", "lunif_loss", "make_loss_fn",
    "normalized_centroids", "pairwise_sq_dists", "random_alignment_loss", "sparsify_loss",
]
