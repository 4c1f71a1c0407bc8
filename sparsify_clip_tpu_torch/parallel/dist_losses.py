"""Global-batch losses from per-rank shards, ported from
:mod:`sparsify_clip_tpu.parallel.dist_losses`.

Each function takes this rank's rows of the embeddings and a
:class:`~sparsify_clip_tpu_torch.parallel.mesh.Mesh`, and returns the
loss over the global batch, the same value on every rank; autograd on a
rank leaves the gradient of that one loss with respect to the rank's own
rows, and a replicated scalar input (temperature, SigLIP's scale and
bias) receives its complete gradient on every rank.  At world 1 each is
its single-device loss.

* :func:`global_contrastive_loss`, :func:`global_lunif_loss`,
  :func:`global_lalign_loss`: all-gather, local-row blocks and a summed
  partial, differentiated by autograd through the collectives of
  :mod:`~sparsify_clip_tpu_torch.parallel.mesh`;
  :func:`global_normalized_centroids` is row-local.
* :func:`ring_siglip_loss` (the JAX package's tests drive it; its train
  step does not): text shards travel the ring, autograd hops back.
* :func:`ring_infonce_loss` and :func:`ring_lunif_loss`: the unrolled
  rings whose peak memory is O(b·D + b²) a rank, each a
  ``torch.autograd.Function`` whose backward is the JAX custom VJP's
  second ring (dist_losses.py:250-292, :356-375): in InfoNCE's the text
  gradient travels with its chunk and comes home on the last hop, and
  the temperature's gradient is summed once over the ranks.

The per-hop blocks are fp32 products with TF32 off
(:func:`~sparsify_clip_tpu_torch.utils.numerics.fp32_matmul`); the JAX
side computes them with XLA, and so do these torch ops.  The single-rank
losses run the CUDA kernels (:mod:`sparsify_clip_tpu_torch.ops`).

Pair-counting note (SURVEY.md §5): ``lunif`` uses the condensed-pdist
convention, N(N−1)/2 unordered distinct pairs: every ordered pair
(i≠j) is counted once across ranks, and dividing by N(N−1) gives the
condensed mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparsify_clip_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce_, hop, psum, pvary, ring_hop,
)
from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul

_NEG = -1e30  # finite -inf stand-in: avoids (-inf) − (-inf) = NaN


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32,
                                                              device=like.device)


def global_contrastive_loss(img_local: torch.Tensor, txt_local: torch.Tensor, temperature,
                            mesh: Mesh) -> torch.Tensor:
    """Symmetric InfoNCE over the global batch: all-gather both modality
    shards, compute only the local-row blocks of both directions' logit
    matrices, and sum the partial cross-entropy sums."""
    b = img_local.shape[0]
    n = b * mesh.data
    temperature = pvary(_scalar(temperature, img_local), mesh)
    img_all = pvary(all_gather(img_local, mesh), mesh)  # (N, D)
    txt_all = pvary(all_gather(txt_local, mesh), mesh)
    logits_i = fp32_matmul(img_local, txt_all.T) / temperature  # (b, N)
    logits_t = fp32_matmul(txt_local, img_all.T) / temperature
    local_ids = mesh.data_rank * b + torch.arange(b, device=img_local.device)
    diag_i = logits_i.gather(1, local_ids[:, None])[:, 0]
    diag_t = logits_t.gather(1, local_ids[:, None])[:, 0]
    part_i = (torch.logsumexp(logits_i, 1) - diag_i).sum()
    part_t = (torch.logsumexp(logits_t, 1) - diag_t).sum()
    return (psum(part_i, mesh) / n + psum(part_t, mesh) / n) / 2.0


def global_lunif_loss(x_local: torch.Tensor, mesh: Mesh, t: float = 2.0) -> torch.Tensor:
    """Condensed-pdist uniformity over the global batch."""
    b = x_local.shape[0]
    n = b * mesh.data
    xl = x_local.float()
    xa = pvary(all_gather(x_local, mesh), mesh).float()  # (N, D)
    gram = fp32_matmul(xl, xa.T)
    nl = xl.square().sum(1)
    na = xa.square().sum(1)
    d2 = torch.clamp(nl[:, None] + na[None, :] - 2.0 * gram, min=0.0)
    w = torch.exp(-t * d2)
    # mask the true diagonal: global row id == global col id
    row_ids = mesh.data_rank * b + torch.arange(b, device=x_local.device)
    col_ids = torch.arange(n, device=x_local.device)
    w = torch.where(row_ids[:, None] == col_ids[None, :], 0.0, w)
    return torch.log(psum(w.sum(), mesh) / (n * (n - 1)))


def global_lalign_loss(x_local: torch.Tensor, y_local: torch.Tensor, mesh: Mesh,
                       alpha: float = 2.0) -> torch.Tensor:
    """Paired alignment: pointwise, so only the mean needs a sum."""
    n = x_local.shape[0] * mesh.data
    sq = (x_local.float() - y_local.float()).square().sum(1)
    local = sq.sum() if alpha == 2.0 else torch.sqrt(sq + 1e-20).pow(alpha).sum()
    return psum(local, mesh) / n


def global_normalized_centroids(img_local: torch.Tensor, txt_local: torch.Tensor) -> torch.Tensor:
    """Paired midpoints are row-local: shard-parallel for free."""
    c = (img_local.float() + txt_local.float()) / 2.0
    return c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-12)


def ring_siglip_loss(img_local: torch.Tensor, txt_local: torch.Tensor, logit_scale, logit_bias,
                     mesh: Mesh) -> torch.Tensor:
    """Ring-chunked global-batch sigmoid loss (the SigLIP paper's chunked
    form): each rank keeps its image shard and the text shards travel the
    ring; at hop k rank r holds the texts of rank r − k and adds that
    block's partial sum.  Positives meet only at hop 0."""
    b = img_local.shape[0]
    n = b * mesh.data
    logit_scale = pvary(_scalar(logit_scale, img_local), mesh)
    logit_bias = pvary(_scalar(logit_bias, img_local), mesh)

    def block(txt_chunk: torch.Tensor, diag_positive: bool) -> torch.Tensor:
        logits = fp32_matmul(img_local, txt_chunk.T) * logit_scale + logit_bias
        if diag_positive:
            idx = torch.arange(b, device=logits.device)
            z = torch.where(idx[:, None] == idx[None, :], 1.0, -1.0)
        else:
            z = -1.0
        return -F.logsigmoid(z * logits).sum()

    total = block(txt_local, True)
    chunk = txt_local
    for _ in range(mesh.data - 1):  # unrolled, as the JAX ring
        chunk = ring_hop(chunk, mesh)
        total = total + block(chunk, False)
    return psum(total, mesh) / n


# --------------------------------------------------------------------
# Ring-chunked losses: per hop only one (b, b) block exists, and the
# softmax / pair statistics accumulate online.  One hop is one
# all_to_all_single of the hop's tensors packed side by side.
# --------------------------------------------------------------------


def _hop_packed(mesh: Mesh, *tensors: torch.Tensor):
    """Send (b, ·) tensors to rank + 1 as one packed (b, Σ·) message."""
    cols = [t if t.ndim == 2 else t[:, None] for t in tensors]
    out = hop(torch.cat(cols, 1), mesh)
    pieces, at = [], 0
    for t, c in zip(tensors, cols):
        w = c.shape[1]
        piece = out[:, at:at + w]
        pieces.append(piece.contiguous() if t.ndim == 2 else piece[:, 0].contiguous())
        at += w
    return pieces


def _infonce_ring_stats(img32, txt32, temp, mesh: Mesh):
    """One ring pass → (row_lse, col_lse), both (b,) local.  Row (image →
    text) statistics stay resident; column (text → image) statistics
    travel with their chunk and come home on a last, stats-only hop."""
    b = img32.shape[0]
    row_max = torch.full((b,), _NEG, dtype=torch.float32, device=img32.device)
    row_sum = torch.zeros((b,), dtype=torch.float32, device=img32.device)
    col_max = torch.full((b,), _NEG, dtype=torch.float32, device=img32.device)
    col_sum = torch.zeros((b,), dtype=torch.float32, device=img32.device)
    chunk = txt32
    for k in range(mesh.data):
        z = fp32_matmul(img32, chunk.T) / temp  # (b, b): the only block
        new_rmax = torch.maximum(row_max, z.max(1).values)
        row_sum = row_sum * torch.exp(row_max - new_rmax) + torch.exp(
            z - new_rmax[:, None]).sum(1)
        row_max = new_rmax
        new_cmax = torch.maximum(col_max, z.max(0).values)
        col_sum = col_sum * torch.exp(col_max - new_cmax) + torch.exp(
            z - new_cmax[None, :]).sum(0)
        col_max = new_cmax
        if k < mesh.data - 1:
            chunk, col_max, col_sum = _hop_packed(mesh, chunk, col_max, col_sum)
        else:  # stats-only hop: brings each chunk's column LSE home
            col_max, col_sum = _hop_packed(mesh, col_max, col_sum)
    return row_max + torch.log(row_sum), col_max + torch.log(col_sum)


class RingInfoNCEFunction(torch.autograd.Function):
    """``apply(img_local, txt_local, temperature, mesh)`` → the global
    symmetric InfoNCE; the backward is a second ring."""

    @staticmethod
    def forward(ctx, img_local, txt_local, temperature, mesh):
        img32, txt32 = img_local.float(), txt_local.float()
        temp = temperature.float()
        n = img32.shape[0] * mesh.data
        row_lse, col_lse = _infonce_ring_stats(img32, txt32, temp, mesh)
        diag = (img32 * txt32).sum(1) / temp  # positives are paired rows
        part = (row_lse - diag).sum() + (col_lse - diag).sum()
        loss = all_reduce_(part.clone(), mesh) / (2.0 * n)
        ctx.mesh = mesh
        ctx.save_for_backward(img_local, txt_local, temperature, row_lse, col_lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        img_local, txt_local, temperature, row_lse, col_lse = ctx.saved_tensors
        mesh = ctx.mesh
        img32, txt32 = img_local.float(), txt_local.float()
        temp = temperature.float()
        b = img32.shape[0]
        n = b * mesh.data
        scale = g.float() / (2.0 * n)
        eye = torch.eye(b, dtype=torch.float32, device=img32.device)
        dimg = torch.zeros_like(img32)
        dtxt = torch.zeros_like(txt32)  # travels with the chunk; returns home
        dtemp_acc = torch.zeros((), dtype=torch.float32, device=img32.device)
        chunk, chunk_lse = txt32, col_lse
        for k in range(mesh.data):
            z = fp32_matmul(img32, chunk.T) / temp
            # dZ = (g/2N)·(softmax_row + softmax_col − 2δ); δ only in the
            # own-chunk block (hop 0), where global row id == col id
            p = torch.exp(z - row_lse[:, None]) + torch.exp(z - chunk_lse[None, :])
            if k == 0:
                p = p - 2.0 * eye
            dz = scale * p
            dimg = dimg + fp32_matmul(dz, chunk) / temp
            dtxt = dtxt + fp32_matmul(dz.T, img32) / temp
            dtemp_acc = dtemp_acc + (dz * z).sum()
            if k < mesh.data - 1:
                chunk, chunk_lse, dtxt = _hop_packed(mesh, chunk, chunk_lse, dtxt)
            else:  # the last hop returns each chunk's gradient to its owner
                (dtxt,) = _hop_packed(mesh, dtxt)
        dtemp = None
        if ctx.needs_input_grad[2]:
            # every rank returns the whole temperature gradient, summed once
            dtemp = (-all_reduce_(dtemp_acc, mesh) / temp).to(temperature.dtype).reshape(
                temperature.shape)
        return dimg.to(img_local.dtype), dtxt.to(txt_local.dtype), dtemp, None


def ring_infonce_loss(img_local: torch.Tensor, txt_local: torch.Tensor, temperature,
                      mesh: Mesh) -> torch.Tensor:
    """Ring-chunked symmetric InfoNCE (sparsify_clip.py:110-132 at global
    batch): text chunks travel the ring, the row LSE accumulates locally
    and the column LSE rides with each chunk; neither pass holds the
    (N, D) gathered matrices.  The raw-divisor temperature
    (sparsify_clip.py:716-717) gets its exact gradient."""
    return RingInfoNCEFunction.apply(img_local, txt_local,
                                     _scalar(temperature, img_local), mesh)


def _lunif_block(x32, chunk, t: float, own_block: bool):
    gram = fp32_matmul(x32, chunk.T)
    nl = x32.square().sum(1)
    nc = chunk.square().sum(1)
    d2 = torch.clamp(nl[:, None] + nc[None, :] - 2.0 * gram, min=0.0)
    w = torch.exp(-t * d2)
    if own_block:  # self-pairs live only where a shard meets itself
        w = w * (1.0 - torch.eye(x32.shape[0], dtype=torch.float32, device=x32.device))
    return w


class RingLunifFunction(torch.autograd.Function):
    """``apply(x_local, t, mesh)`` → the global condensed-pdist uniformity;
    the backward recomputes the blocks around a second ring."""

    @staticmethod
    def forward(ctx, x_local, t, mesh):
        x32 = x_local.float()
        n = x32.shape[0] * mesh.data
        chunk = x32
        total = torch.zeros((), dtype=torch.float32, device=x32.device)
        for k in range(mesh.data):
            total = total + _lunif_block(x32, chunk, t, k == 0).sum()
            if k < mesh.data - 1:
                chunk = hop(chunk, mesh)
        s = all_reduce_(total, mesh)  # Σ_{i≠j} over ordered pairs
        ctx.t, ctx.mesh = t, mesh
        ctx.save_for_backward(x_local, s)
        return torch.log(s / (n * (n - 1)))

    @staticmethod
    def backward(ctx, g):
        x_local, s = ctx.saved_tensors
        t, mesh = ctx.t, ctx.mesh
        x32 = x_local.float()
        chunk = x32
        r = torch.zeros((x32.shape[0],), dtype=torch.float32, device=x32.device)
        wx = torch.zeros_like(x32)
        # W is symmetric, so each rank's row sums close after one loop; no
        # gradient travels (unlike InfoNCE's dtxt)
        for k in range(mesh.data):
            w = _lunif_block(x32, chunk, t, k == 0)
            r = r + w.sum(1)
            wx = wx + fp32_matmul(w, chunk)
            if k < mesh.data - 1:
                chunk = hop(chunk, mesh)
        dx = (-4.0 * t / s) * (x32 * r[:, None] - wx)
        return (g.float() * dx).to(x_local.dtype), None, None


def ring_lunif_loss(x_local: torch.Tensor, mesh: Mesh, t: float = 2.0) -> torch.Tensor:
    """Ring-chunked condensed-pdist uniformity (sparsify_clip.py:159-164
    at global batch): dx_i = −4t/S·(r_i·x_i − (Wx)_i)."""
    return RingLunifFunction.apply(x_local, t, mesh)
