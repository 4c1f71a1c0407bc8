"""loss_type string → loss function, ported from
:mod:`sparsify_clip_tpu.losses.dispatch`.

The table keeps every ``loss_type`` string of the reference
(sparsify_clip.py:778-930) and of the JAX package, spelled exactly, and
every string runs.  ``anchor-roberta`` needs the (B, B) soft targets and
``siglip`` its two scalars in the :class:`LossContext`; without them they
raise the JAX ``ValueError``s.

**Dead-elif semantics preserved** (SURVEY.md §2.6): the reference tests
the identical string ``"only_lunif_n_then_anchor+lalign+BETA*lunif(centroids)"``
twice (sparsify_clip.py:813 and :833); Python takes the first branch, so
experiments 7 and 8 both run the **per-modality** β-weighted uniformity.
The unreachable centroid branch is kept under the non-reference name
``"__dead__anchor+lalign+BETA*lunif(centroids)"``.

The ``only_lunif_epochs`` warm phase (pure per-modality uniformity while
``epoch < only_lunif_epochs``) is a Python ``if ctx.warm``: only the live
branch runs, as ``lax.cond`` runs only its live branch on the JAX side.

On one rank InfoNCE always goes through the fused
:func:`sparsify_clip_tpu_torch.ops.infonce.infonce_loss` and uniformity
through :func:`sparsify_clip_tpu_torch.ops.lunif.lunif_loss`: their CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.  None is
routed through a plain version on the card: that would hide a missing
kernel.  The soft-target loss and the sigmoid loss are plain PyTorch
everywhere, as the JAX side computes them with XLA under every
``use_pallas`` (its ``make_loss_fn`` swaps InfoNCE and uniformity alone).

**The route** (the JAX ``_mesh_route``, ops/fused.py:127-221): with no
``mesh`` in the :class:`LossContext`, or one of one rank, the kernels run
on the whole batch.  Over W > 1 ranks each rank holds its rows of the
embeddings: InfoNCE and uniformity take the rings of
:mod:`sparsify_clip_tpu_torch.parallel.dist_losses` (the centroids are
row-local, so their uniformity rings too), ``lalign`` is pointwise and
sums one scalar (``global_lalign_loss``), and SigLIP and
``anchor-roberta`` run on embeddings gathered by
:func:`~sparsify_clip_tpu_torch.parallel.mesh.all_gather`, whose backward
keeps the rank's own rows of the replicated gradient.  Every rank gets
the same global loss; a replicated scalar's gradient (the temperature,
SigLIP's scale and bias) is complete on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from sparsify_clip_tpu_torch.losses.align import lalign_loss
from sparsify_clip_tpu_torch.losses.centroids import normalized_centroids
from sparsify_clip_tpu_torch.losses.contrastive import contrastive_loss_roberta
from sparsify_clip_tpu_torch.losses.sigmoid import siglip_loss
from sparsify_clip_tpu_torch.ops.infonce import infonce_loss
from sparsify_clip_tpu_torch.ops.lunif import lunif_loss
from sparsify_clip_tpu_torch.parallel.dist_losses import (
    global_lalign_loss, ring_infonce_loss, ring_lunif_loss,
)
from sparsify_clip_tpu_torch.parallel.mesh import Mesh, all_gather

Aux = Dict[str, torch.Tensor]
LossFn = Callable[..., Tuple[torch.Tensor, Aux]]


@dataclasses.dataclass
class LossContext:
    """Per-step scalars threaded into the loss.

    ``temperature`` is the raw divisor (a tensor on the embeddings'
    device, learnable or not).  ``beta``/``alpha`` are the schedules at
    the 1-based batch index; ``warm`` is ``epoch < only_lunif_epochs``.
    ``soft_targets`` is the (B, B) row-stochastic matrix of
    ``anchor-roberta`` (host-computed, shipped with the batch);
    ``logit_scale`` (the positive ``exp`` of the learnable log-scale) and
    ``logit_bias`` are SigLIP's.  Each is None for every other loss type.
    ``mesh`` is the step's data-parallel mesh; None, or one rank, takes the
    single-device route.
    """

    temperature: Union[torch.Tensor, float]
    beta: float = 0.0
    alpha: float = 0.0
    warm: bool = False
    soft_targets: Optional[torch.Tensor] = None
    logit_scale: Optional[torch.Tensor] = None
    logit_bias: Optional[torch.Tensor] = None
    mesh: Optional[Mesh] = None


def loss_route(mesh: Optional[Mesh]) -> str:
    """``"kernel"`` (one rank: the kernels on the whole batch) or
    ``"ring"`` (the rings, the summed lalign and the gathered terms over
    the ranks)."""
    return "ring" if mesh is not None and mesh.data > 1 else "kernel"


# The functions below look ``infonce_loss`` and ``lunif_loss`` up in this
# module when they run, so a caller may swap either for its plain version
# (chip_smoke.py's comparison step does).


def _infonce(img, txt, ctx: LossContext) -> torch.Tensor:
    if loss_route(ctx.mesh) == "ring":
        return ring_infonce_loss(img, txt, ctx.temperature, ctx.mesh)
    return infonce_loss(img, txt, ctx.temperature)


def _lunif(x, ctx: LossContext) -> torch.Tensor:
    if loss_route(ctx.mesh) == "ring":
        return ring_lunif_loss(x, ctx.mesh)
    return lunif_loss(x)


def _gathered(ctx: LossContext, *xs):
    """The whole batch of each embedding, for SigLIP and ``anchor-roberta``."""
    if loss_route(ctx.mesh) == "ring":
        return tuple(all_gather(x, ctx.mesh) for x in xs)
    return xs


def _lalign(img, txt, ctx: LossContext) -> torch.Tensor:
    if loss_route(ctx.mesh) == "ring":  # pointwise: one summed scalar, no gather
        return global_lalign_loss(img, txt, ctx.mesh)
    return lalign_loss(img, txt)


def _modality_lunif(img, txt, ctx: LossContext) -> torch.Tensor:
    return (_lunif(img, ctx) + _lunif(txt, ctx)) / 2.0


def _warm_lunif(img, txt, ctx: LossContext) -> Tuple[torch.Tensor, Aux]:
    """The only_lunif warm phase: pure per-modality uniformity
    (e.g. sparsify_clip.py:796-799)."""
    loss = _modality_lunif(img, txt, ctx)
    zero = loss.new_zeros(())
    return loss, {"anchor": zero, "lalign": zero, "lunif": loss}


def _anchor_only(img, txt, ctx: LossContext) -> Tuple[torch.Tensor, Aux]:
    loss = _infonce(img, txt, ctx)
    zero = loss.new_zeros(())
    return loss, {"anchor": loss, "lalign": zero, "lunif": zero}


def _anchor_lalign_lunif_modality(img, txt, ctx: LossContext):
    anchor = _infonce(img, txt, ctx)
    lalign = _lalign(img, txt, ctx)
    lunif = _modality_lunif(img, txt, ctx)
    return anchor + lunif + lalign, {"anchor": anchor, "lalign": lalign, "lunif": lunif}


def _anchor_lalign_lunif_centroids(img, txt, ctx: LossContext):
    anchor = _infonce(img, txt, ctx)
    lunif_c = _lunif(normalized_centroids(img, txt), ctx)
    lalign = _lalign(img, txt, ctx)
    return anchor + lalign + lunif_c, {"anchor": anchor, "lalign": lalign, "lunif": lunif_c}


def _anchor_lalign_beta_lunif_modality(img, txt, ctx: LossContext):
    # Executed semantics of BOTH experiments 7 and 8 (dead-elif; see the
    # module docstring and sparsify_clip.py:813-829).
    anchor = _infonce(img, txt, ctx)
    lunif = _modality_lunif(img, txt, ctx)
    lalign = _lalign(img, txt, ctx)
    return anchor + lalign + ctx.beta * lunif, {"anchor": anchor, "lalign": lalign, "lunif": lunif}


def _anchor_lalign_beta_lunif_centroids_dead(img, txt, ctx: LossContext):
    # The unreachable reference branch (sparsify_clip.py:833-851).
    anchor = _infonce(img, txt, ctx)
    lunif_c = _lunif(normalized_centroids(img, txt), ctx)
    lalign = _lalign(img, txt, ctx)
    return anchor + lalign + ctx.beta * lunif_c, {
        "anchor": anchor, "lalign": lalign, "lunif": lunif_c,
    }


def _anchor_alpha_lalign_beta_lunif_modality(img, txt, ctx: LossContext):
    # Experiment 9 (sparsify_clip.py:854-875).
    anchor = _infonce(img, txt, ctx)
    lunif = _modality_lunif(img, txt, ctx)
    lalign = _lalign(img, txt, ctx)
    return anchor + ctx.alpha * lalign + ctx.beta * lunif, {
        "anchor": anchor, "lalign": lalign, "lunif": lunif,
    }


def _anchor_alpha_lalign_beta_lunif_centroids(img, txt, ctx: LossContext):
    # Experiment 10 (sparsify_clip.py:879-902).
    anchor = _infonce(img, txt, ctx)
    lunif_c = _lunif(normalized_centroids(img, txt), ctx)
    lalign = _lalign(img, txt, ctx)
    return anchor + ctx.alpha * lalign + ctx.beta * lunif_c, {
        "anchor": anchor, "lalign": lalign, "lunif": lunif_c,
    }


def _anchor_roberta(img, txt, ctx: LossContext):
    # The reference selects this surface but its dispatch branch is
    # commented out (sparsify_clip.py:1196-1202); the JAX package runs it
    # on host-supplied soft targets, and so does the port.
    if ctx.soft_targets is None:
        raise ValueError(
            "loss_type 'anchor-roberta' needs a (B, B) 'soft_targets' "
            "matrix in the batch dict (host-computed sentence "
            "similarities, row-stochastic)."
        )
    loss = contrastive_loss_roberta(*_gathered(ctx, img, txt), ctx.soft_targets,
                                    ctx.temperature)
    zero = loss.new_zeros(())
    return loss, {"anchor": loss, "lalign": zero, "lunif": zero}


def _siglip(img, txt, ctx: LossContext):
    # Framework extension (losses/sigmoid.py); the train step threads the
    # scalars from TrainState.loss_scalars.
    if ctx.logit_scale is None or ctx.logit_bias is None:
        raise ValueError(
            "loss_type 'siglip' needs logit_scale/logit_bias in the "
            "LossContext (the train loop supplies them from "
            "TrainState.loss_scalars; direct callers must pass both)."
        )
    loss = siglip_loss(*_gathered(ctx, img, txt), ctx.logit_scale, ctx.logit_bias)
    zero = loss.new_zeros(())
    return loss, {"anchor": loss, "lalign": zero, "lunif": zero}


def _anchor_lalign(img, txt, ctx: LossContext):
    # Ablation 1 (sparsify_clip.py:922-927).
    anchor = _infonce(img, txt, ctx)
    lalign = _lalign(img, txt, ctx)
    return anchor + lalign, {"anchor": anchor, "lalign": lalign, "lunif": anchor.new_zeros(())}


def _anchor_lunif_centroids(img, txt, ctx: LossContext):
    # Ablation 2 (sparsify_clip.py:930-938).
    anchor = _infonce(img, txt, ctx)
    lunif_c = _lunif(normalized_centroids(img, txt), ctx)
    return anchor + lunif_c, {"anchor": anchor, "lalign": anchor.new_zeros(()), "lunif": lunif_c}


def _anchor_plus_lunif(img, txt, ctx: LossContext):
    anchor = _infonce(img, txt, ctx)
    lunif = _modality_lunif(img, txt, ctx)
    return anchor + lunif, {"anchor": anchor, "lalign": anchor.new_zeros(()), "lunif": lunif}


# loss_type → (main-phase fn, has_warm_phase).  Strings are the exact
# reference spellings, then the JAX package's extras.
_DISPATCH: Dict[str, Tuple[LossFn, bool]] = {
    "anchor": (_anchor_only, False),
    "anchor-roberta": (_anchor_roberta, False),
    "only_lunif_n_then_anchor+lalign+lunif(text)+lunif(img)": (
        _anchor_lalign_lunif_modality, True),
    "only_lunif_n_then_anchor+lalign+lunif(centroids)": (_anchor_lalign_lunif_centroids, True),
    "only_lunif_n_then_anchor+lalign+BETA*lunif(centroids)": (
        _anchor_lalign_beta_lunif_modality, True),  # dead-elif semantics
    "only_lunif_n_then_anchor+ALPHA*lalign+BETA*(lunif(text)+lunif(img))": (
        _anchor_alpha_lalign_beta_lunif_modality, True),
    "only_lunif_n_then_anchor+ALPHA*lalign+BETA*lunif(centroids)": (
        _anchor_alpha_lalign_beta_lunif_centroids, True),
    "ANCHOR(IMAGE,TEXT)+LALIGN(IMAGE,TEXT)+LUNIF(CENTROIDS)": (
        _anchor_lalign_lunif_centroids, False),
    "ANCHOR(IMAGE,TEXT)+LALIGN(IMAGE,TEXT)": (_anchor_lalign, False),
    "ANCHOR(IMAGE,TEXT)+LUNIF(CENTROIDS)": (_anchor_lunif_centroids, False),
    # Non-reference extras of the JAX package:
    "__dead__anchor+lalign+BETA*lunif(centroids)": (
        _anchor_lalign_beta_lunif_centroids_dead, True),
    "lunif": (_warm_lunif, False),
    "siglip": (_siglip, False),
    "anchor+lunif": (_anchor_plus_lunif, False),
}

KNOWN_LOSS_TYPES = tuple(k for k in _DISPATCH if not k.startswith("__dead__"))


def make_loss_fn(loss_type: str) -> LossFn:
    """Return ``fn(image_embeds, text_embeds, ctx) -> (loss, aux)``.

    ``aux`` holds the scalar components ``anchor``, ``lalign`` and
    ``lunif`` (zeros where a component does not apply), as on the JAX
    side.
    """
    if loss_type not in _DISPATCH:
        raise ValueError(f"Unknown loss_type {loss_type!r}. Known: {sorted(_DISPATCH)}")
    main_fn, has_warm = _DISPATCH[loss_type]
    if not has_warm:
        return main_fn

    def fn(img, txt, ctx: LossContext):
        return _warm_lunif(img, txt, ctx) if ctx.warm else main_fn(img, txt, ctx)

    return fn
