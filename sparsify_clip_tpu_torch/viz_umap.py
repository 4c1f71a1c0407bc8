"""Self-contained UMAP for the embedding sphere plots, a copy of
:mod:`sparsify_clip_tpu.viz_umap` (numpy; the same seed gives the same
embedding bit for bit).

The reference's per-eval triple plot runs ``umap.UMAP(n_components=3,
n_jobs=8)`` (sparsify_clip.py:235); umap-learn rides a numba/llvmlite
stack, which may be missing.  This module implements the UMAP
algorithm (McInnes, Healy & Melville 2018) at the scale the viz path
actually uses (≤1000 points, viz.py samples ≤500 pairs), with
umap-learn's defaults: n_neighbors=15 exact (brute-force) kNN, fuzzy
simplicial set with per-point rho/sigma calibrated to log2(k),
probabilistic t-conorm symmetrization, a/b curve fit for
min_dist=0.1 / spread=1.0 (scipy curve_fit, matching umap's
find_ab_params), spectral initialization from the normalized graph
Laplacian, and 500 epochs of the attract/repel SGD with 5× negative
sampling and a linearly decaying learning rate.

Exact where umap-learn approximates (NN-descent, sparse ops): at panel
size the dense O(N²) computations are fractions of a second, and the
embedding quality question is the calibrated graph + loss, which are
the same.  ``viz._reduce`` prefers umap-learn when importable.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def _find_ab_params(spread: float, min_dist: float) -> tuple[float, float]:
    """Least-squares fit of 1/(1 + a d^(2b)) to the target membership
    curve — umap.umap_.find_ab_params verbatim in spirit.  Cached: the
    fit is a pure function of (spread, min_dist) and the viz path calls
    it with the defaults every eval pass."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv)
    return float(a), float(b)


def _fuzzy_graph(x: np.ndarray, n_neighbors: int) -> np.ndarray:
    """Symmetrized fuzzy simplicial set as a dense (N, N) weight matrix."""
    from sparsify_clip_tpu_torch.viz_tsne import _pairwise_sq_dists

    n = x.shape[0]
    d = np.sqrt(_pairwise_sq_dists(x))
    np.fill_diagonal(d, np.inf)
    knn_idx = np.argsort(d, axis=1)[:, :n_neighbors]
    knn_d = np.take_along_axis(d, knn_idx, axis=1)

    rho = knn_d[:, 0]
    target = np.log2(n_neighbors)
    # vectorized bisection for per-point sigma
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    sigma = np.ones(n)
    shifted = np.maximum(knn_d - rho[:, None], 0.0)
    for _ in range(64):
        s = np.exp(-shifted / sigma[:, None]).sum(axis=1)
        too_big = s > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(~too_big, sigma, lo)
        grow = ~too_big & np.isinf(hi)
        sigma = np.where(grow, sigma * 2.0, (lo + np.where(np.isinf(hi), sigma * 2.0, hi)) / 2.0)
    sigma = np.maximum(sigma, 1e-3 * np.maximum(knn_d.mean(axis=1), 1e-12))

    w = np.zeros((n, n))
    rows = np.repeat(np.arange(n), n_neighbors)
    cols = knn_idx.ravel()
    vals = np.exp(-shifted / sigma[:, None]).ravel()
    w[rows, cols] = vals
    # probabilistic t-conorm: a + b - a*b
    return w + w.T - w * w.T


def _spectral_init(graph: np.ndarray, n_components: int, seed: int) -> np.ndarray:
    """Eigenvectors 1..k of the symmetric normalized Laplacian, scaled
    to umap's ±10 box (with noise fallback on degenerate graphs)."""
    deg = graph.sum(axis=1)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(graph.shape[0]) - inv_sqrt[:, None] * graph * inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(lap)
    order = np.argsort(vals)
    emb = vecs[:, order[1: n_components + 1]]
    scale = np.abs(emb).max()
    rng = np.random.default_rng(seed)
    if not np.isfinite(scale) or scale < 1e-12:
        return rng.uniform(-10, 10, size=(graph.shape[0], n_components))
    emb = 10.0 * emb / scale
    return emb + rng.normal(0, 1e-4, emb.shape)


def umap_embed(
    data: np.ndarray,
    n_components: int = 3,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    spread: float = 1.0,
    n_epochs: int = 500,
    negative_sample_rate: int = 5,
    learning_rate: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """UMAP embedding of ``data`` (N, D) → (N, n_components)."""
    x = np.asarray(data, np.float64)
    n = x.shape[0]
    if n <= n_components + 1:
        out = np.zeros((n, n_components))
        out[:, : min(n_components, x.shape[1])] = x[:, :n_components]
        return out
    n_neighbors = min(n_neighbors, n - 1)

    a, b = _find_ab_params(spread, min_dist)
    graph = _fuzzy_graph(x, n_neighbors)
    y = _spectral_init(graph, n_components, seed).astype(np.float64)

    # Both directions of every edge, as in umap-learn's COO walk: each
    # endpoint then appears as a head, so negative-sampling repulsion is
    # applied symmetrically (keeping only heads < tails would starve
    # high-index points of repulsion — they'd only ever be tails).
    heads, tails = np.nonzero(graph)
    weights = graph[heads, tails]
    w_max = weights.max()
    sample_p = weights / max(w_max, 1e-12)

    # SGD in float32 (umap-learn's working dtype) with bincount-based
    # scatter-adds — np.add.at's buffered fancy indexing is ~4× slower
    # than a per-component bincount at panel-size edge counts
    y = y.astype(np.float32)
    k = y.shape[1]

    def scatter_add(target, idx, contrib, alpha):
        for c in range(k):
            target[:, c] += alpha * np.bincount(
                idx, weights=contrib[:, c], minlength=n
            ).astype(np.float32)

    rng = np.random.default_rng(seed)
    for epoch in range(n_epochs):
        alpha = np.float32(learning_rate * (1.0 - epoch / n_epochs))
        mask = rng.random(heads.shape[0]) < sample_p
        h, t = heads[mask], tails[mask]
        if h.size == 0:
            continue

        diff = y[h] - y[t]
        d2 = np.maximum(np.sum(diff * diff, axis=1), np.float32(1e-12))
        # attraction: d/dy of log(1/(1 + a d^{2b}))
        coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b)
        grad = np.clip(coef[:, None] * diff, -4.0, 4.0)
        scatter_add(y, h, grad, alpha)
        scatter_add(y, t, grad, -alpha)

        # repulsion: negative samples for each sampled edge head
        neg = rng.integers(0, n, size=(h.size, negative_sample_rate))
        yh = y[h][:, None, :]                       # (E, 1, C)
        diff_n = yh - y[neg]                        # (E, S, C)
        d2n = np.sum(diff_n * diff_n, axis=2)
        coef_n = (2.0 * b) / ((0.001 + d2n) * (1.0 + a * d2n ** b))
        coef_n = np.where(neg == h[:, None], 0.0, coef_n)
        grad_n = np.clip(coef_n[..., None] * diff_n, -4.0, 4.0)
        scatter_add(y, h, grad_n.sum(axis=1), alpha)
    return y.astype(np.float64)
