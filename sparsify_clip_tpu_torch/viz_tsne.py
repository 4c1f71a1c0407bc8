"""Self-contained exact t-SNE for the embedding sphere plots, ported from
:mod:`sparsify_clip_tpu.viz_tsne`: the affinities are its numpy code, the
descent its jitted loop written in torch on the CPU.

The reference's per-eval triple plot runs openTSNE's
``TSNE(n_components=3, n_jobs=1)`` (sparsify_clip.py:232) — a library
that is absent from this environment AND from the reference's own
environment.yml (latent env bug, SURVEY.md §2.11).  Rather than gate
the t-SNE panel on an uninstallable import, this module implements the
standard exact algorithm (van der Maaten & Hinton 2008) the way
openTSNE's defaults configure it: perplexity 30 via per-point
binary-searched Gaussian bandwidths, symmetrized affinities, PCA
initialization, early exaggeration 12 with momentum 0.5 → 0.8, and
adaptive per-dimension gains.

Exact (O(N²)) rather than Barnes-Hut/FFT: the viz path samples ≤500
pairs → ≤1000 points (viz.py), where the dense computation is
milliseconds-per-iteration on host and has no approximation error.
``viz._reduce`` prefers openTSNE when importable (byte-level parity
with the reference's exact library) and falls back to this.

The gradient descent (750 sequential O(N²) iterations) is the JAX
module's ``lax.fori_loop`` in fp32 as torch operations on an explicit CPU
device, under ``torch.no_grad``: on the host, never the card, so
plotting does not contend with training for the device.
"""

from __future__ import annotations

import numpy as np
import torch


def _pairwise_sq_dists(x: np.ndarray) -> np.ndarray:
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, 0.0)
    return np.maximum(d2, 0.0)


def _conditional_probs(d2: np.ndarray, perplexity: float) -> np.ndarray:
    """Row-stochastic P(j|i) with per-row beta binary-searched so each
    row's Shannon entropy hits log(perplexity).

    All rows are searched simultaneously (vectorized bisection with
    doubling/halving for unbracketed bounds) — the per-row Python loop
    is the hot spot at plot sizes."""
    n = d2.shape[0]
    target = np.log(perplexity)
    eye = np.eye(n, dtype=bool)

    beta = np.ones(n)
    beta_lo = np.zeros(n)
    beta_hi = np.full(n, np.inf)
    for _ in range(64):
        w = np.exp(-d2 * beta[:, None])
        w[eye] = 0.0
        s = np.maximum(w.sum(axis=1), 1e-12)
        q = w / s[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            h = -np.sum(np.where(q > 0, q * np.log(q), 0.0), axis=1)
        done = np.abs(h - target) < 1e-5
        if done.all():
            break
        flat = h > target  # entropy too high → sharpen (raise beta)
        beta_lo = np.where(flat & ~done, beta, beta_lo)
        beta_hi = np.where(~flat & ~done, beta, beta_hi)
        grow = flat & np.isinf(beta_hi)
        shrink = ~flat & (beta_lo == 0.0)
        mid = np.where(np.isinf(beta_hi), beta, (beta_lo + beta_hi) / 2.0)
        beta = np.where(
            done, beta,
            np.where(grow, beta * 2.0, np.where(shrink, beta / 2.0, mid)),
        )
    w = np.exp(-d2 * beta[:, None])
    w[eye] = 0.0
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)


def _descent(p: np.ndarray, y0: np.ndarray, lr: float, exaggeration: float,
             early_iter: int, n_iter: int) -> np.ndarray:
    """The t-SNE gradient descent (the JAX ``_descent_jit`` loop) in fp32
    on the CPU: early exaggeration with momentum 0.5, then momentum 0.8,
    per-dimension gains, the embedding re-centred each iteration."""
    cpu = torch.device("cpu")
    with torch.no_grad():
        p_t = torch.as_tensor(p, dtype=torch.float32, device=cpu)
        y = torch.as_tensor(y0, dtype=torch.float32, device=cpu).clone()
        n = y.shape[0]
        off_diag = 1.0 - torch.eye(n, dtype=torch.float32, device=cpu)
        gains, update = torch.ones_like(y), torch.zeros_like(y)
        lr_t = torch.tensor(lr, dtype=torch.float32)
        for it in range(early_iter + n_iter):
            exag = torch.tensor(exaggeration if it < early_iter else 1.0, dtype=torch.float32)
            momentum = torch.tensor(0.5 if it < early_iter else 0.8, dtype=torch.float32)

            sq = torch.sum(y * y, dim=1)
            d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (y @ y.T), min=0.0)
            w = off_diag / (1.0 + d2)     # Student-t kernel, zero diagonal
            q = torch.clamp(w / torch.sum(w), min=1e-12)

            # grad_i = 4 Σ_j (exag·p_ij − q_ij) w_ij (y_i − y_j)
            pq = (exag * p_t - q) * w
            grad = 4.0 * (torch.sum(pq, dim=1, keepdim=True) * y - pq @ y)

            same_sign = torch.sign(grad) == torch.sign(update)
            gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
            update = momentum * update - lr_t * gains * grad
            y = y + update
            y = y - torch.mean(y, dim=0, keepdim=True)
    return y.numpy()


def tsne(
    data: np.ndarray,
    n_components: int = 3,
    perplexity: float = 30.0,
    early_exaggeration: float = 12.0,
    early_iter: int = 250,
    n_iter: int = 500,
    learning_rate: float | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Exact t-SNE embedding of ``data`` (N, D) → (N, n_components)."""
    x = np.asarray(data, np.float64)
    n = x.shape[0]
    if n <= n_components + 1:
        out = np.zeros((n, n_components))
        out[:, : min(n_components, x.shape[1])] = x[:, :n_components]
        return out
    perplexity = min(perplexity, (n - 1) / 3.0)
    if learning_rate is None:
        learning_rate = max(200.0, n / early_exaggeration)  # openTSNE "auto"

    cond = _conditional_probs(_pairwise_sq_dists(x), perplexity)
    p = (cond + cond.T) / (2.0 * n)
    # the descent runs float32 like openTSNE — affinities are computed
    # in float64 above (the bisection needs the range), the loop doesn't
    p = np.maximum(p, 1e-12).astype(np.float32)

    # PCA init scaled to std 1e-4 per t-SNE convention (openTSNE default
    # initialization="pca" with rescaling)
    centered = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    y = centered @ vt[:n_components].T
    y = (y / max(y[:, 0].std(), 1e-12) * 1e-4).astype(np.float32)
    rng = np.random.default_rng(seed)
    if np.allclose(y, 0.0):  # degenerate input: jitter
        y = 1e-4 * rng.standard_normal((n, n_components)).astype(np.float32)

    y = _descent(p, y, learning_rate, early_exaggeration, early_iter, n_iter)
    return y.astype(np.float64)
