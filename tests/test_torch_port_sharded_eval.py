"""The port's sharded eval over 2 and 3 ranks against its one-rank eval
and the JAX ``evaluate_model`` on a ``data=W`` mesh, on the CPU.

Each rank (a fresh gloo process, ``tests/torch_dp_worker.py``) encodes
its rows of every eval batch with the fp32 twin of a bf16 ``tiny-test``
model carrying the JAX weights; ``allgather_to_host`` gives every rank
the whole set in batch order, and each computes the 13 metrics.  Two
sets a world: batches of 12 (6 or 4 rows a rank) and batches of W (one
row a rank, b_local = 1).

Tolerances: every rank's metrics are equal; the gathered embeddings
equal the one-rank encode to rtol 1e-5, atol 1e-6 (fp32 towers at
other batch sizes); the 4-decimal metrics equal the one-rank eval's and
the JAX eval's up to one rounding step (1e-4), as
tests/test_torch_port_eval.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import eval as jax_eval
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.parallel.mesh import create_mesh
from sparsify_clip_tpu_torch import eval as port_eval
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models.clip import create_model

import torch_dp_worker

WORLDS = (2, 3)
SEEDS = (40, 41, 42)
KEYS = {"forward_r1", "forward_r5", "forward_r10", "forward_ravg", "backward_r1",
        "backward_r5", "backward_r10", "backward_ravg", "gap", "mean_angular_value_image",
        "mean_angular_value_text", "uniformity", "mean_cosine_similarity_true_pairs"}
EMBED_TOL = dict(rtol=1e-5, atol=1e-6)


def _sets(world):
    return {"b12": 12, "b1": world}


@pytest.fixture(scope="module")
def jax_model():
    jmodel = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY["tiny-test"], dtype=jnp.bfloat16)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 77), jnp.int32),
        train=False)
    return jmodel, variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_model):
    _, variables = jax_model
    out = {}
    for world in WORLDS:
        directory = str(tmp_path_factory.mktemp(f"eval{world}"))
        weights = os.path.join(directory, "weights.npz")
        np.savez(weights, **collect_host_arrays(variables["params"]))
        cases = [dict(name=name, model="tiny-test", dtype="bfloat16", weights=weights,
                      batch=batch, image_size=32, batch_seeds=list(SEEDS))
                 for name, batch in _sets(world).items()]
        results = torch_dp_worker.spawn("eval", dict(cases=cases), directory, world)
        out[world] = dict(results=results,
                          arrays=[torch_dp_worker.arrays(directory, "eval", r)
                                  for r in range(world)])
    return out


def _batches(batch):
    return [synthetic_batch(batch, 32, seed=s) for s in SEEDS]


def _one_rank(jax_model, batch):
    _, variables = jax_model
    model = create_model("tiny-test", dtype=torch.bfloat16, device="cpu",
                         param_dtype=torch.float32, seed=0)
    load_jax_params(model, collect_host_arrays(variables["params"]))
    twin = port_eval.make_eval_model(model.train())
    img, txt = port_eval.encode_eval_set(twin, _batches(batch))
    return port_eval.evaluate_model(twin, _batches(batch)), img.numpy(), txt.numpy()


@pytest.mark.parametrize("name", ["b12", "b1"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_eval_equals_the_one_rank_eval(runs, jax_model, world, name):
    batch = _sets(world)[name]
    results = [r[name] for r in runs[world]["results"]]
    assert all(r == results[0] for r in results)  # identical on every rank
    got = results[0]
    assert set(got) == KEYS
    want, img, txt = _one_rank(jax_model, batch)
    for arrays in runs[world]["arrays"]:  # every rank gathered the whole set
        np.testing.assert_allclose(arrays[f"{name}/img"], img, **EMBED_TOL)
        np.testing.assert_allclose(arrays[f"{name}/txt"], txt, **EMBED_TOL)
    for key in KEYS:
        assert got[key] == pytest.approx(want[key], abs=1e-4 + 1e-12), key


@pytest.mark.parametrize("name", ["b12", "b1"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_eval_equals_the_jax_eval_on_the_mesh(runs, jax_model, world, name):
    """The JAX eval shards each batch over a ``data=W`` mesh (eval.py:197-246)."""
    jmodel, variables = jax_model
    mesh = create_mesh(data=world, model=1, devices=jax.devices()[:world])
    want = jax_eval.evaluate_model(jax_eval.make_eval_model(jmodel), variables,
                                   _batches(_sets(world)[name]), mesh=mesh)
    got = runs[world]["results"][0][name]
    for key in KEYS:
        assert got[key] == pytest.approx(want[key], abs=1e-4 + 1e-12), key
