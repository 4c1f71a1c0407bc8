"""Evaluation: retrieval and embedding-geometry metrics, ported from
:mod:`sparsify_clip_tpu.eval`.

The reference's 13-metric dict, with its keys and 4-decimal rounding
(sparsify_clip.py:534-676): ``forward_r1/r5/r10/ravg`` (text→image),
``backward_r1/r5/r10/ravg`` (image→text), ``gap``,
``mean_angular_value_image/text``, ``uniformity`` and
``mean_cosine_similarity_true_pairs``.

Ranks are strictly-greater counts against the ground-truth score, as on
the JAX side (the reference sorts; the two agree for distinct scores),
over the similarity ``txt @ img.T`` in fp32 (TF32 off).

Over a data-parallel ``mesh`` of W > 1 ranks (JAX eval.py:197-246) each
rank encodes its slice of every eval batch (the loaders hand each rank
its slice), every rank gathers the whole set in batch order
(:func:`~sparsify_clip_tpu_torch.parallel.multihost.allgather_to_host`)
and computes the 13 metrics identically; the CLI's primary logs them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from sparsify_clip_tpu_torch.metrics.unif_w2 import eval_uniformity
from sparsify_clip_tpu_torch.models.clip import CLIP
from sparsify_clip_tpu_torch.parallel.mesh import Mesh
from sparsify_clip_tpu_torch.parallel.multihost import allgather_to_host
from sparsify_clip_tpu_torch.parallel.sharding import layout_of
from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul, l2_normalize

GEOMETRY_KEYS = ("gap", "mean_angular_value_image", "mean_angular_value_text", "uniformity",
                 "mean_cosine_similarity_true_pairs")


def retrieval_ranks(similarity: torch.Tensor, ids_img: torch.Tensor,
                    ids_txt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranks of both directions over ``similarity`` (N_text, N_image).
    ``ids_*`` map rows and columns to sample ids; an image with several
    captions takes the min rank over them (sparsify_clip.py:394-401), that
    is the rank of its best-scoring ground-truth caption."""
    sim = similarity.float()
    gt_scores = torch.where(ids_txt[:, None] == ids_img[None, :], sim, float("-inf"))
    rank_f = (sim > gt_scores.max(1).values[:, None]).sum(1)
    rank_b = (sim > gt_scores.max(0).values[None, :]).sum(0)
    return rank_f, rank_b


def _recall_block(rank: np.ndarray, prefix: str) -> Dict[str, float]:
    n = rank.shape[0]
    r1 = float((rank < 1).sum()) / n
    r5 = float((rank < 5).sum()) / n
    r10 = float((rank < 10).sum()) / n
    return {
        f"{prefix}_r1": round(r1 * 100, 4),
        f"{prefix}_r5": round(r5 * 100, 4),
        f"{prefix}_r10": round(r10 * 100, 4),
        f"{prefix}_ravg": round((r1 + r5 + r10) / 3 * 100, 4),
    }


def compute_gap(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """‖mean(f1) − mean(f2)‖₂, the modality gap (sparsify_clip.py:418-436)."""
    diff = feat1.float().mean(0) - feat2.float().mean(0)
    return torch.sqrt((diff * diff).sum())


def mean_angular_value(feat: torch.Tensor) -> torch.Tensor:
    """Mean off-diagonal cosine within a modality (sparsify_clip.py:438-457)."""
    n = feat.shape[0]
    cos = fp32_matmul(feat, feat.T)
    return (cos.sum() - cos.diagonal().sum()) / (n * (n - 1))


def mean_true_pair_cosine(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """Mean cosine of the true pairs (sparsify_clip.py:508-528)."""
    return (feat1.float() * feat2.float()).sum(1).mean()


def metric_values(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Both rank vectors and the five geometry metrics, unrounded, from the
    **unnormalized** accumulated embeddings (the reference normalizes after
    accumulating, sparsify_clip.py:624-625)."""
    img, txt = l2_normalize(image_embeds), l2_normalize(text_embeds)
    ids = torch.arange(img.shape[0], device=img.device)
    rank_f, rank_b = retrieval_ranks(fp32_matmul(txt, img.T), ids, ids)
    return {
        "rank_f": rank_f,
        "rank_b": rank_b,
        "gap": compute_gap(img, txt),
        "mean_angular_value_image": mean_angular_value(img),
        "mean_angular_value_text": mean_angular_value(txt),
        "uniformity": eval_uniformity(img, txt),
        "mean_cosine_similarity_true_pairs": mean_true_pair_cosine(img, txt),
    }


def compute_all_metrics(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> Dict[str, float]:
    """The reference's final_log dict (sparsify_clip.py:659-667)."""
    core = metric_values(image_embeds, text_embeds)
    out: Dict[str, float] = {}
    out.update(_recall_block(core["rank_f"].cpu().numpy(), "forward"))
    out.update(_recall_block(core["rank_b"].cpu().numpy(), "backward"))
    for key in GEOMETRY_KEYS:
        out[key] = round(float(core[key]), 4)
    return out


def make_eval_model(model: CLIP, eval_fp32: bool = True) -> CLIP:
    """The model evaluation runs, in eval mode: an fp32-compute twin of a
    bf16 training model when ``eval_fp32``, else a twin in the model's own
    type; a model already of that type and in eval mode is returned as it
    is.  A twin computes over the training model's own parameter and
    buffer tensors (not copies), so every eval sees the weights and the
    BatchNorm running statistics of that moment, as the JAX CLI passes
    ``batch_stats`` to ``evaluate_model`` (cli.py:196-198).  The reference
    evaluates with no autocast (sparsify_clip.py:563-593).  A model laid
    out over the mesh (``model.layout``) gives a twin of one process over
    full copies of its parameters, those of this moment: call it again
    for later weights (a collective).  A pipelined model's twin is the
    same stage of the same pipeline over its own tensors, as the JAX CLI
    evaluates the pipelined model (cli.py builds its eval model from the
    train step's): every model rank runs it together."""
    dtype = torch.float32 if eval_fp32 else model.dtype
    layout = layout_of(model)
    if layout is not None and not layout.pipeline:
        return layout.full_model(model, dtype).eval()
    if model.dtype == dtype and not model.training:
        return model
    return model.with_dtype(dtype).eval()


def encode_eval_set(model: CLIP, batches: Iterable[Dict[str, np.ndarray]],
                    mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both towers over every batch, under ``torch.no_grad``, on the
    model's device → the concatenated **unnormalized** (img, txt).  Over a
    ``mesh`` of W > 1 ranks the batches are this rank's slices, and each
    chunk is gathered from every rank (a collective) before the
    concatenation, so every rank returns the whole set in batch order."""
    img_chunks, txt_chunks = [], []
    with torch.no_grad():
        for batch in batches:
            images = torch.as_tensor(batch["images"], dtype=torch.float32).to(model.device)
            tokens = torch.as_tensor(batch["tokens"]).to(model.device)
            img_chunks.append(model.encode_image(images))
            txt_chunks.append(model.encode_text(tokens))
    if mesh is not None and mesh.data > 1:
        img_chunks = [torch.from_numpy(allgather_to_host(c, mesh)).to(model.device)
                      for c in img_chunks]
        txt_chunks = [torch.from_numpy(allgather_to_host(c, mesh)).to(model.device)
                      for c in txt_chunks]
    return torch.cat(img_chunks), torch.cat(txt_chunks)


def evaluate_model(
    model: CLIP,
    batches: Iterable[Dict[str, np.ndarray]],
    plot_embeddings: bool = False,
    plot_fn: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, float]:
    """Sweep the eval set and compute the 13 metrics (reference:
    evaluate_model, sparsify_clip.py:534-676).  ``batches`` yields dicts
    with ``images`` (B, H, W, 3) and ``tokens`` (B, 77), this rank's
    slices over a ``mesh`` of several ranks; ``plot_fn(txt, img)`` gets
    the whole set's unnormalized embeddings as numpy arrays."""
    img, txt = encode_eval_set(model, batches, mesh)
    if plot_embeddings and plot_fn is not None:
        plot_fn(txt.cpu().numpy(), img.cpu().numpy())
    return compute_all_metrics(img, txt)
