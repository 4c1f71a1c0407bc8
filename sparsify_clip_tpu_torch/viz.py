"""Embedding visualization: 3-D PCA / t-SNE / UMAP sphere scatter plots,
a copy of :mod:`sparsify_clip_tpu.viz` (host code; importing the JAX
package would import JAX).

Host-side counterpart of ``visualize_embeddings``
(sparsify_clip.py:192-302): sample up to 500 pairs, jointly reduce to
3 components, renormalize onto the unit sphere, scatter text (red) vs
vision (blue) on fixed [-1, 1] axes, save a PNG.  PCA is computed with
an SVD (no sklearn dependency needed); t-SNE and UMAP use their
reference libraries when importable (openTSNE / umap-learn,
sparsify_clip.py:232,235) and otherwise the in-repo implementations
(viz_tsne.py / viz_umap.py) — openTSNE is missing from the
reference's own environment.yml (latent env bug, SURVEY.md §2.11) and
umap-learn rides a numba stack, so fallbacks, not gates, keep the
reference's per-eval triple plot alive.  The plots run on the host,
never on the card, so plotting does not contend with training for it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _reduce_pca(data: np.ndarray, k: int = 3) -> np.ndarray:
    centered = data - data.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:k].T


def _reduce(data: np.ndarray, method: str) -> np.ndarray:
    if method == "pca":
        return _reduce_pca(data)
    if method == "tsne":
        try:
            from openTSNE import TSNE  # type: ignore

            return np.asarray(TSNE(n_components=3, n_jobs=1).fit(data))
        except ImportError:
            # self-contained exact fallback (viz_tsne.py) — the plot
            # panel no longer gates on an uninstallable library
            from sparsify_clip_tpu_torch.viz_tsne import tsne

            return tsne(data, n_components=3)
    if method == "umap":
        try:
            import umap  # type: ignore

            return np.asarray(
                umap.UMAP(n_components=3, n_jobs=8).fit_transform(data)
            )
        except ImportError:
            # self-contained fallback (viz_umap.py): same calibrated
            # fuzzy graph + SGD, exact kNN at panel size
            from sparsify_clip_tpu_torch.viz_umap import umap_embed

            return umap_embed(data, n_components=3)
    raise NotImplementedError(f"method {method!r}: only pca/tsne/umap")


def visualize_embeddings(
    text_embeddings: np.ndarray,
    vision_embeddings: np.ndarray,
    sample_size: int = 500,
    method: str = "pca",
    title: str = "Embeddings Visualization",
    save_path: Optional[str] = None,
    seed: int = 0,
) -> Optional[str]:
    """Render one sphere plot; returns the saved path (None if no save
    path was given — every reducer always produces an embedding, the
    library imports fall back to the in-repo implementations)."""
    text_np = np.asarray(text_embeddings, np.float64)
    vision_np = np.asarray(vision_embeddings, np.float64)

    n = min(text_np.shape[0], vision_np.shape[0])
    if sample_size != -1 and n > sample_size:
        idx = np.random.default_rng(seed).choice(n, size=sample_size, replace=False)
        text_np, vision_np = text_np[idx], vision_np[idx]

    reduced = _reduce(np.concatenate([text_np, vision_np], axis=0), method.lower())
    norms = np.linalg.norm(reduced, axis=1, keepdims=True)
    reduced = reduced / np.maximum(norms, 1e-12)
    text_r = reduced[: len(text_np)]
    vision_r = reduced[len(text_np):]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(text_r[:, 0], text_r[:, 1], text_r[:, 2], c="red", alpha=0.6, label="Text")
    ax.scatter(
        vision_r[:, 0], vision_r[:, 1], vision_r[:, 2], c="blue", alpha=0.6,
        label="Vision",
    )
    ax.set_xlim(-1, 1); ax.set_ylim(-1, 1); ax.set_zlim(-1, 1)
    ax.set_title(title)
    ax.set_xlabel("Component 1"); ax.set_ylabel("Component 2"); ax.set_zlabel("Component 3")
    ax.legend()

    if save_path is None:
        return None
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_all_methods(
    text_embeddings: np.ndarray,
    vision_embeddings: np.ndarray,
    out_dir: str,
    tag: str,
    logger=None,
) -> None:
    """The reference's per-eval triple plot (umap/tsne/pca,
    sparsify_clip.py:599-620), logged when a logger is given."""
    for method in ("umap", "tsne", "pca"):
        path = visualize_embeddings(
            text_embeddings, vision_embeddings, sample_size=500, method=method,
            title="CLIP Embeddings Visualization",
            save_path=os.path.join(out_dir, f"embeddings_{method}_{tag}.png"),
        )
        if path and logger is not None:
            logger.log_image(method, path)
