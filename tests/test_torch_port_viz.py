"""The embedding plots (``viz.py``, ``viz_tsne.py``, ``viz_umap.py``) and
the CLI's per-eval triple plot in the port against the JAX package, on
the CPU.

* The copies equal their originals: PCA to 1e-10, the numpy UMAP to the
  bit from the same seed (over 100 epochs), the t-SNE affinities to 1e-12; the t-SNE
  descent (a torch loop on the CPU where JAX jits a ``fori_loop``) after
  3 exaggerated and 3 plain iterations to rtol 1e-4 of the JAX descent
  (both fp32; XLA fuses the elementwise chain in its own order).
* The JAX tests' cluster-separation checks (tests/test_logging_viz.py's
  ``test_builtin_tsne_separates_clusters`` and
  ``test_builtin_umap_separates_clusters``) on the port's reducers.
* The CLI on ``configs/smoke_tiny.yaml`` with ``plot_embeddings: true``
  (at batch 16): ``plot_all_methods`` writes the UMAP, t-SNE and PCA PNGs
  of each of the 3 eval passes, tagged with the pass counter, and logs
  them ahead of the pass's metrics.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from sparsify_clip_tpu import viz as jax_viz
from sparsify_clip_tpu import viz_tsne as jax_tsne
from sparsify_clip_tpu import viz_umap as jax_umap
from sparsify_clip_tpu_torch import cli, viz, viz_tsne, viz_umap
from sparsify_clip_tpu_torch.config import load_config

pytest.importorskip("matplotlib")  # the plots need it; the reducers do not

SMOKE_TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "smoke_tiny.yaml")


def _two_clusters():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((60, 64)) * 0.3
    b = rng.standard_normal((60, 64)) * 0.3 + 4.0
    return np.concatenate([a, b])


def _separated(y):
    ca, cb = y[:60].mean(0), y[60:].mean(0)
    intra = max(np.linalg.norm(y[:60] - ca, axis=1).mean(),
                np.linalg.norm(y[60:] - cb, axis=1).mean())
    return np.linalg.norm(ca - cb) > 2 * intra


def test_pca_equals_the_original():
    x = np.random.default_rng(1).standard_normal((200, 24))
    np.testing.assert_allclose(viz._reduce_pca(x), jax_viz._reduce_pca(x), rtol=1e-10, atol=1e-10)


def test_umap_equals_the_original_to_the_bit_and_separates_clusters():
    x = _two_clusters()
    # the copy's SGD against the original's over 100 epochs; the default 500
    # for the JAX test's separation check
    np.testing.assert_array_equal(viz_umap.umap_embed(x, n_components=3, n_epochs=100, seed=3),
                                  jax_umap.umap_embed(x, n_components=3, n_epochs=100, seed=3))
    y = viz_umap.umap_embed(x, n_components=3, seed=3)
    assert y.shape == (120, 3) and np.isfinite(y).all() and _separated(y)
    np.testing.assert_array_equal(viz_umap._fuzzy_graph(x, 15), jax_umap._fuzzy_graph(x, 15))
    assert viz_umap._find_ab_params(1.0, 0.1) == jax_umap._find_ab_params(1.0, 0.1)


def test_tsne_affinities_equal_the_original():
    x = np.random.default_rng(2).standard_normal((150, 32))
    got = viz_tsne._conditional_probs(viz_tsne._pairwise_sq_dists(x), 30.0)
    want = jax_tsne._conditional_probs(jax_tsne._pairwise_sq_dists(x), 30.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)


def test_tsne_descent_matches_the_jax_descent():
    x = np.random.default_rng(4).standard_normal((90, 16))
    got = viz_tsne.tsne(x, n_components=3, early_iter=3, n_iter=3)
    want = jax_tsne.tsne(x, n_components=3, early_iter=3, n_iter=3)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_tsne_separates_clusters():
    y = viz_tsne.tsne(_two_clusters(), n_components=3)
    assert y.shape == (120, 3) and np.isfinite(y).all() and _separated(y)


def test_the_cli_plots_every_eval_pass(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # batch 16: 32 training pairs, one eval batch of 16 pairs a pass
    config = dataclasses.replace(cli.apply_smoke_overrides(dataclasses.replace(
        load_config(SMOKE_TINY), batch_size=16)), plot_embeddings=True)
    cli.main(config, device="cpu")
    records = [json.loads(line) for line in open(
        tmp_path / "logs" / "smoke-tiny" / "smoke-tiny-smoke.jsonl")]
    images = [r for r in records if r.get("event") == "image"]
    evals = [i for i, r in enumerate(records) if "forward_r1" in r]
    assert len(evals) == 3 and len(images) == 9
    # each pass's three plots are logged before its metrics, tagged with
    # the pass counter
    for k, at in enumerate(evals):
        mine = records[at - 3:at]
        assert [r["key"] for r in mine] == ["umap", "tsne", "pca"]
        for r in mine:
            name = os.path.basename(r["path"])
            assert name.startswith(f"embeddings_{r['key']}_{k:04d}_") and name.endswith(".png")
            assert os.path.getsize(r["path"]) > 1000
