"""loss_type string → loss function, ported from
:mod:`sparsify_clip_tpu.losses.dispatch`.

The table keeps every ``loss_type`` string of the reference
(sparsify_clip.py:778-930) and of the JAX package, spelled exactly.
Every string runs except ``anchor-roberta`` (the soft-target loss) and
``siglip``, which raise :class:`NotImplementedError` naming what they
wait for (ROADMAP Queue 1 item 2).

**Dead-elif semantics preserved** (SURVEY.md §2.6): the reference tests
the identical string ``"only_lunif_n_then_anchor+lalign+BETA*lunif(centroids)"``
twice (sparsify_clip.py:813 and :833); Python takes the first branch, so
experiments 7 and 8 both run the **per-modality** β-weighted uniformity.
The unreachable centroid branch is kept under the non-reference name
``"__dead__anchor+lalign+BETA*lunif(centroids)"``.

The ``only_lunif_epochs`` warm phase (pure per-modality uniformity while
``epoch < only_lunif_epochs``) is a Python ``if ctx.warm``: only the live
branch runs, as ``lax.cond`` runs only its live branch on the JAX side.

InfoNCE always goes through the fused
:func:`sparsify_clip_tpu_torch.ops.infonce.infonce_loss` and uniformity
through :func:`sparsify_clip_tpu_torch.ops.lunif.lunif_loss`: their CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.  None is
routed through a plain version on the card: that would hide a missing
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

from sparsify_clip_tpu_torch.losses.align import lalign_loss
from sparsify_clip_tpu_torch.losses.centroids import normalized_centroids
from sparsify_clip_tpu_torch.ops.infonce import infonce_loss
from sparsify_clip_tpu_torch.ops.lunif import lunif_loss

Aux = Dict[str, torch.Tensor]
LossFn = Callable[..., Tuple[torch.Tensor, Aux]]


@dataclasses.dataclass
class LossContext:
    """Per-step scalars threaded into the loss.

    ``temperature`` is the raw divisor (a tensor on the embeddings'
    device, learnable or not).  ``beta``/``alpha`` are the schedules at
    the 1-based batch index; ``warm`` is ``epoch < only_lunif_epochs``.
    The JAX context's ``soft_targets`` and SigLIP scalars belong to loss
    types that are not ported yet.
    """

    temperature: Union[torch.Tensor, float]
    beta: float = 0.0
    alpha: float = 0.0
    warm: bool = False


# The functions below look ``infonce_loss`` and ``lunif_loss`` up in this
# module when they run, so a caller may swap either for its plain version
# (chip_smoke.py's comparison step does).


def _modality_lunif(img, txt) -> torch.Tensor:
    return (lunif_loss(img) + lunif_loss(txt)) / 2.0


def _warm_lunif(img, txt, ctx: LossContext) -> Tuple[torch.Tensor, Aux]:
    """The only_lunif warm phase: pure per-modality uniformity
    (e.g. sparsify_clip.py:796-799)."""
    loss = _modality_lunif(img, txt)
    zero = loss.new_zeros(())
    return loss, {"anchor": zero, "lalign": zero, "lunif": loss}


def _anchor_only(img, txt, ctx: LossContext) -> Tuple[torch.Tensor, Aux]:
    loss = infonce_loss(img, txt, ctx.temperature)
    zero = loss.new_zeros(())
    return loss, {"anchor": loss, "lalign": zero, "lunif": zero}


def _anchor_lalign_lunif_modality(img, txt, ctx: LossContext):
    anchor = infonce_loss(img, txt, ctx.temperature)
    lalign = lalign_loss(img, txt)
    lunif = _modality_lunif(img, txt)
    return anchor + lunif + lalign, {"anchor": anchor, "lalign": lalign, "lunif": lunif}


def _anchor_lalign_lunif_centroids(img, txt, ctx: LossContext):
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif_c = lunif_loss(normalized_centroids(img, txt))
    lalign = lalign_loss(img, txt)
    return anchor + lalign + lunif_c, {"anchor": anchor, "lalign": lalign, "lunif": lunif_c}


def _anchor_lalign_beta_lunif_modality(img, txt, ctx: LossContext):
    # Executed semantics of BOTH experiments 7 and 8 (dead-elif; see the
    # module docstring and sparsify_clip.py:813-829).
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif = _modality_lunif(img, txt)
    lalign = lalign_loss(img, txt)
    return anchor + lalign + ctx.beta * lunif, {"anchor": anchor, "lalign": lalign, "lunif": lunif}


def _anchor_lalign_beta_lunif_centroids_dead(img, txt, ctx: LossContext):
    # The unreachable reference branch (sparsify_clip.py:833-851).
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif_c = lunif_loss(normalized_centroids(img, txt))
    lalign = lalign_loss(img, txt)
    return anchor + lalign + ctx.beta * lunif_c, {
        "anchor": anchor, "lalign": lalign, "lunif": lunif_c,
    }


def _anchor_alpha_lalign_beta_lunif_modality(img, txt, ctx: LossContext):
    # Experiment 9 (sparsify_clip.py:854-875).
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif = _modality_lunif(img, txt)
    lalign = lalign_loss(img, txt)
    return anchor + ctx.alpha * lalign + ctx.beta * lunif, {
        "anchor": anchor, "lalign": lalign, "lunif": lunif,
    }


def _anchor_alpha_lalign_beta_lunif_centroids(img, txt, ctx: LossContext):
    # Experiment 10 (sparsify_clip.py:879-902).
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif_c = lunif_loss(normalized_centroids(img, txt))
    lalign = lalign_loss(img, txt)
    return anchor + ctx.alpha * lalign + ctx.beta * lunif_c, {
        "anchor": anchor, "lalign": lalign, "lunif": lunif_c,
    }


def _anchor_lalign(img, txt, ctx: LossContext):
    # Ablation 1 (sparsify_clip.py:922-927).
    anchor = infonce_loss(img, txt, ctx.temperature)
    lalign = lalign_loss(img, txt)
    return anchor + lalign, {"anchor": anchor, "lalign": lalign, "lunif": anchor.new_zeros(())}


def _anchor_lunif_centroids(img, txt, ctx: LossContext):
    # Ablation 2 (sparsify_clip.py:930-938).
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif_c = lunif_loss(normalized_centroids(img, txt))
    return anchor + lunif_c, {"anchor": anchor, "lalign": anchor.new_zeros(()), "lunif": lunif_c}


def _anchor_plus_lunif(img, txt, ctx: LossContext):
    anchor = infonce_loss(img, txt, ctx.temperature)
    lunif = _modality_lunif(img, txt)
    return anchor + lunif, {"anchor": anchor, "lalign": anchor.new_zeros(()), "lunif": lunif}


# loss_type → (main-phase fn, has_warm_phase), or what the string waits
# for.  Strings are the exact reference spellings, then the JAX package's
# extras.
_DISPATCH: Dict[str, Union[Tuple[LossFn, bool], str]] = {
    "anchor": (_anchor_only, False),
    "anchor-roberta": "the soft-target loss contrastive_loss_roberta and the host "
                      "soft-target provider (ROADMAP Queue 1 item 2)",
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
    "siglip": "losses/sigmoid.py (ROADMAP Queue 1 item 2)",
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
    entry = _DISPATCH[loss_type]
    if isinstance(entry, str):
        raise NotImplementedError(
            f"loss_type {loss_type!r} is not ported to sparsify_clip_tpu_torch yet: "
            f"it waits for {entry}"
        )
    main_fn, has_warm = entry
    if not has_warm:
        return main_fn

    def fn(img, txt, ctx: LossContext):
        return _warm_lunif(img, txt, ctx) if ctx.warm else main_fn(img, txt, ctx)

    return fn
