"""The port's eval and W₂ metrics against the JAX package's, on the CPU.

* ``metric_values``/``compute_all_metrics`` and each helper against JAX
  on the same numpy embeddings (ranks exactly; fp32 geometry metrics to
  ``GEOM``: eigvalsh and the sums run in other orders);
* the five W₂ variants against JAX;
* ``retrieval_ranks`` with duplicate ids (min rank over an image's
  captions) and ties (strict ``>`` counts);
* ``evaluate_model`` over the fp32 twin of a bf16 ``tiny-test`` model
  carrying the JAX weights, against the JAX ``evaluate_model`` over its
  own fp32 twin;
* the twin computes over the training model's parameter storage.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import eval as jax_eval
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.metrics import unif_w2 as jax_w2
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch import eval as port_eval
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.metrics import unif_w2
from sparsify_clip_tpu_torch.models.clip import create_model
from sparsify_clip_tpu_torch.train import create_train_setup, run_training

# fp32 geometry metrics: the same formulas, sums and eigenvalues taken in
# other orders
GEOM = dict(rel=1e-5, abs=1e-6)
KEYS = {f"{d}_{r}" for d in ("forward", "backward") for r in ("r1", "r5", "r10", "ravg")} | set(
    port_eval.GEOMETRY_KEYS)


def _embeds(n, d, seed, scale=3.0):
    """Unnormalized embeddings with a shared offset (a modality gap)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * scale + rng.standard_normal(d)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _embeds(96, 24, 0), _embeds(96, 24, 1)


def test_metric_values_match_the_jax_metric_core(pair):
    img, txt = pair
    want = jax_eval._metric_core(jnp.asarray(img), jnp.asarray(txt))
    got = port_eval.metric_values(torch.from_numpy(img), torch.from_numpy(txt))
    assert set(got) == set(want)
    for key in ("rank_f", "rank_b"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in port_eval.GEOMETRY_KEYS:
        assert float(got[key]) == pytest.approx(float(want[key]), **GEOM), key


def test_compute_all_metrics_matches_jax(pair):
    img, txt = pair
    want = jax_eval.compute_all_metrics(jnp.asarray(img), jnp.asarray(txt))
    got = port_eval.compute_all_metrics(torch.from_numpy(img), torch.from_numpy(txt))
    assert set(got) == set(want) == KEYS
    for key in KEYS:
        # the 4-decimal values agree up to one rounding step
        assert got[key] == pytest.approx(want[key], abs=1e-4 + 1e-12), key
        assert isinstance(got[key], float)


@pytest.mark.parametrize("name", ["compute_gap", "mean_true_pair_cosine", "mean_angular_value"])
def test_geometry_helpers_match_jax(pair, name):
    img, txt = (v / np.linalg.norm(v, axis=1, keepdims=True) for v in pair)
    args = (img, txt) if name != "mean_angular_value" else (img,)
    want = getattr(jax_eval, name)(*map(jnp.asarray, args))
    got = getattr(port_eval, name)(*map(torch.from_numpy, args))
    assert float(got) == pytest.approx(float(want), **GEOM)


@pytest.mark.parametrize("name", ["unif_w2_single_svd", "unif_w2_eig_real", "unif_w2_abs_eig",
                                  "unif_w2_joint", "eval_uniformity"])
def test_w2_variants_match_jax(pair, name):
    img, txt = (v / np.linalg.norm(v, axis=1, keepdims=True) for v in pair)
    args = (img, txt) if name in ("unif_w2_joint", "eval_uniformity") else (img,)
    want = getattr(jax_w2, name)(*map(jnp.asarray, args))
    got = getattr(unif_w2, name)(*map(torch.from_numpy, args))
    assert np.isfinite(float(got))
    assert float(got) == pytest.approx(float(want), **GEOM)


def test_retrieval_ranks_with_duplicate_ids_and_ties():
    rng = np.random.default_rng(4)
    sim = np.round(rng.standard_normal((12, 7)), 1).astype(np.float32)  # rounded: ties
    ids_txt = rng.integers(0, 7, size=12)
    ids_txt[:7] = np.arange(7)  # every image has at least one caption
    ids_img = np.arange(7)
    want = jax_eval.retrieval_ranks(jnp.asarray(sim), jnp.asarray(ids_img), jnp.asarray(ids_txt))
    got = port_eval.retrieval_ranks(torch.from_numpy(sim), torch.from_numpy(ids_img),
                                    torch.from_numpy(ids_txt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the JAX test's hand example: image 0 keeps the rank of its best caption
    sim = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.5, 0.3]])
    _, rank_b = port_eval.retrieval_ranks(sim, torch.tensor([0, 1]), torch.tensor([0, 1, 0]))
    assert rank_b.tolist() == [0, 0]


def test_recall_block_rounds_as_jax():
    rank = np.random.default_rng(5).integers(0, 20, size=37)
    for prefix in ("forward", "backward"):
        assert port_eval._recall_block(rank, prefix) == jax_eval._recall_block(rank, prefix)


# ------------------------------------------------------------ the model eval


def _eval_batches():
    return [synthetic_batch(16, 32, seed=s) for s in (30, 31)]


def test_evaluate_model_matches_the_jax_eval_over_the_fp32_twin():
    # what jax_clip.create_model("tiny-test", jnp.bfloat16) returns, with
    # the init jitted (one compile instead of many eager ones)
    jmodel = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY["tiny-test"], dtype=jnp.bfloat16)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 77), jnp.int32),
        train=False)
    flat = collect_host_arrays(variables["params"])
    jax_twin = jax_eval.make_eval_model(jmodel)
    want = jax_eval.evaluate_model(jax_twin, variables, _eval_batches())

    model = create_model("tiny-test", dtype=torch.bfloat16, device="cpu",
                         param_dtype=torch.float32).train()
    load_jax_params(model, flat)
    twin = port_eval.make_eval_model(model)
    assert twin.dtype == torch.float32 and jax_twin.dtype == jnp.float32
    got = port_eval.evaluate_model(twin, _eval_batches())
    assert set(got) == set(want) == KEYS
    for key in KEYS:
        # fp32 towers on both sides (embeddings agree to ~1e-6): the same
        # ranks, and the 4-decimal values up to one rounding step
        assert got[key] == pytest.approx(want[key], abs=1e-4 + 1e-12), key


def test_eval_twin_shares_the_training_models_parameters():
    model = create_model("tiny-test", dtype=torch.bfloat16, device="cpu",
                         param_dtype=torch.float32).train()
    twin = port_eval.make_eval_model(model)
    assert model.dtype == torch.bfloat16 and twin.dtype == torch.float32
    pairs = list(zip(model.named_parameters(), twin.named_parameters()))
    assert len(pairs) == len(list(model.parameters())) > 0
    assert all(n1 == n2 and p1 is p2 for (n1, p1), (n2, p2) in pairs)
    batches = _eval_batches()[:1]
    before = port_eval.encode_eval_set(twin, batches)[0]
    with torch.no_grad():
        model.visual.proj.mul_(2.0)  # an optimizer step, in place
    after = port_eval.encode_eval_set(twin, batches)[0]
    torch.testing.assert_close(after, 2.0 * before, rtol=1e-6, atol=1e-6)
    assert port_eval.make_eval_model(twin) is twin  # already fp32
    assert port_eval.make_eval_model(model, eval_fp32=False) is model


def test_per_epoch_eval_inside_run_training():
    """The eval_fn the trainer runs before training and after each epoch,
    built on evaluate_model over the twin, sees the weights of that
    moment and hands plot_fn the (txt, img) embeddings."""
    cfg = port_config.ExperimentConfig.from_dict(dict(
        model="tiny-test", batch_size=4, epochs=2, learning_rate=1e-2, seed=0,
        loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1))
    setup = create_train_setup(cfg, steps_per_epoch=2, device="cpu")
    twin = port_eval.make_eval_model(setup.model, cfg.eval_fp32)
    batches, results, plotted = _eval_batches(), [], []

    def eval_fn(state):
        results.append(port_eval.evaluate_model(
            twin, batches, plot_embeddings=True,
            plot_fn=lambda txt, img: plotted.append((txt.shape, img.shape))))
        return results[-1]

    run_training(setup, lambda epoch: (synthetic_batch(4, 32, seed=10 * epoch + i)
                                       for i in range(2)), eval_fn=eval_fn)
    assert len(results) == 3 and all(set(r) == KEYS for r in results)
    assert all(np.isfinite(list(r.values())).all() for r in results)
    assert results[0] != results[-1]  # the weights moved between the evals
    assert plotted == [((32, 16), (32, 16))] * 3
