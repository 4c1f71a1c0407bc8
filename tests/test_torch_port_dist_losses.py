"""The port's global-batch losses (``parallel/dist_losses.py``) and its
loss route over several ranks against the JAX package, on the CPU.

Each world size W ∈ {2, 3, 5} runs once, as W gloo processes started
fresh (``tests/torch_dp_worker.py``, torch and the port only); every rank
computes each function on its rows and writes its value and its rows'
gradients.  Here the JAX side runs the same function under ``shard_map``
on a ``data=W`` sub-mesh of the 8 fake CPU devices
(``create_mesh(data=W, devices=jax.devices()[:W])``), value and per-shard
gradients, and the single-device JAX loss on the whole batch gives the
replicated scalars' gradients (temperature, SigLIP's scale and bias).
Two batches a world: 4 rows a rank, and one row a rank (b_local = 1).

Tolerances (fp32, unit rows): values rtol 1e-5; embedding gradients
rtol 1e-4, atol 1e-6, as tests/test_dist_losses.py; scalar gradients
rtol 1e-4.  Every rank must report the same value and scalar gradients,
and the ring temperature gradient must be the whole one (summed once):
W times it, or a 1/W share, would miss by far more.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sparsify_clip_tpu.losses import dispatch as jax_dispatch
from sparsify_clip_tpu.losses.align import lalign_loss
from sparsify_clip_tpu.losses.centroids import normalized_centroids
from sparsify_clip_tpu.losses.contrastive import contrastive_loss
from sparsify_clip_tpu.losses.sigmoid import siglip_loss
from sparsify_clip_tpu.losses.unif import lunif_loss
from sparsify_clip_tpu.parallel import dist_losses as jdl
from sparsify_clip_tpu.parallel.mesh import create_mesh

import torch_dp_worker

WORLDS = (2, 3, 5)
D = 16
T0, SCALE0, BIAS0 = 0.1, 10.0, -10.0
ROUTES = ("only_lunif_n_then_anchor+lalign+lunif(centroids)", "siglip",
          "only_lunif_n_then_anchor+lalign+lunif(text)+lunif(img)")
VALUE_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SCALAR_RTOL = 1e-4


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case_inputs(world, rows_per_rank, seed):
    rng = np.random.default_rng(seed)
    n = world * rows_per_rank
    return dict(img=_unit(rng, n), txt=_unit(rng, n),
                w=rng.standard_normal((n, D)).astype(np.float32))


CASES = {"b4": 4, "b1": 1}

# name → (JAX per-shard function of (img, txt, T, scale, bias, w), which
# of T/scale/bias it reads)
JAX_FNS = {
    "global_contrastive": (lambda i, t, T, s, b, w: jdl.global_contrastive_loss(i, t, T), "T"),
    "ring_infonce": (lambda i, t, T, s, b, w: jdl.ring_infonce_loss(i, t, T), "T"),
    "global_lunif": (lambda i, t, T, s, b, w: jdl.global_lunif_loss(i), ""),
    "ring_lunif": (lambda i, t, T, s, b, w: jdl.ring_lunif_loss(i), ""),
    "ring_lunif_centroids": (lambda i, t, T, s, b, w: jdl.ring_lunif_loss(
        jdl.global_normalized_centroids(i, t)), ""),
    "global_lalign": (lambda i, t, T, s, b, w: jdl.global_lalign_loss(i, t), ""),
    "global_lalign_alpha3": (lambda i, t, T, s, b, w: jdl.global_lalign_loss(i, t, 3.0), ""),
    "global_centroids": (lambda i, t, T, s, b, w: jax.lax.psum(
        jnp.sum(jdl.global_normalized_centroids(i, t) * w), "data"), ""),
    "ring_siglip": (lambda i, t, T, s, b, w: jdl.ring_siglip_loss(i, t, s, b), "scale,bias"),
}
# the single-device JAX loss on the whole batch, for the scalars' gradients
JAX_GLOBAL = {
    "global_contrastive": lambda i, t, T, s, b: contrastive_loss(i, t, T),
    "ring_infonce": lambda i, t, T, s, b: contrastive_loss(i, t, T),
    "ring_siglip": lambda i, t, T, s, b: siglip_loss(i, t, s, b),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's ranks once: every case, function and route."""
    out = {}
    for world in WORLDS:
        directory = str(tmp_path_factory.mktemp(f"world{world}"))
        cases = []
        for name, rows in CASES.items():
            path = os.path.join(directory, f"{name}.npz")
            np.savez(path, **_case_inputs(world, rows, seed=world * 10 + rows))
            cases.append(dict(name=name, inputs=path, temperature=T0, scale=SCALE0,
                              bias=BIAS0))
        results = torch_dp_worker.spawn("losses", dict(cases=cases, routes=list(ROUTES)),
                                        directory, world)
        grads = [torch_dp_worker.arrays(directory, "losses", r) for r in range(world)]
        out[world] = dict(results=results, grads=grads, directory=directory)
    return out


def _jax_sharded(world, name, inputs):
    """(value, dimg, dtxt) of the JAX function under shard_map on data=W."""
    mesh = create_mesh(data=world, model=1, devices=jax.devices()[:world])
    fn, _ = JAX_FNS[name]
    spec = P("data")

    def per_shard(i, t, w):
        return jax.value_and_grad(
            lambda i, t: fn(i, t, jnp.float32(T0), jnp.float32(SCALE0), jnp.float32(BIAS0), w),
            argnums=(0, 1))(i, t)

    value, (di, dt) = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(spec, spec, spec),
                                        out_specs=(P(), (spec, spec))))(
        jnp.asarray(inputs["img"]), jnp.asarray(inputs["txt"]), jnp.asarray(inputs["w"]))
    return float(value), np.asarray(di), np.asarray(dt)


def _port(runs, world, case, name):
    key = f"{case}/{name}"
    values = [r[f"{key}/loss"] for r in runs[world]["results"]]
    dimg = np.concatenate([g[f"{key}/dimg"] for g in runs[world]["grads"]])
    dtxt = np.concatenate([g[f"{key}/dtxt"] for g in runs[world]["grads"]])
    scalars = {s: [r[f"{key}/d{s}"] for r in runs[world]["results"]]
               for s in ("T", "scale", "bias")}
    return values, dimg, dtxt, scalars


def _inputs(world, case):
    return _case_inputs(world, CASES[case], seed=world * 10 + CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(JAX_FNS))
@pytest.mark.parametrize("world", WORLDS)
def test_dist_loss_matches_jax_in_value_and_gradient(runs, world, name, case):
    inputs = _inputs(world, case)
    values, dimg, dtxt, scalars = _port(runs, world, case, name)
    want, want_i, want_t = _jax_sharded(world, name, inputs)
    assert len(set(values)) == 1, values  # the same loss on every rank
    assert values[0] == pytest.approx(want, rel=VALUE_RTOL, abs=1e-7)
    np.testing.assert_allclose(dimg, want_i, **GRAD_TOL)
    np.testing.assert_allclose(dtxt, want_t, **GRAD_TOL)
    if name in JAX_GLOBAL:
        args = [jnp.asarray(inputs["img"]), jnp.asarray(inputs["txt"]),
                jnp.float32(T0), jnp.float32(SCALE0), jnp.float32(BIAS0)]
        full = jax.grad(JAX_GLOBAL[name], argnums=(2, 3, 4))(*args)
        for key, g in zip(("T", "scale", "bias"), full):
            if key in JAX_FNS[name][1]:
                assert len(set(scalars[key])) == 1, scalars[key]
                assert scalars[key][0] == pytest.approx(float(g), rel=SCALAR_RTOL), key


@pytest.mark.parametrize("world", WORLDS)
def test_ring_temperature_gradient_is_summed_once(runs, world):
    """JAX's own in-shard_map temperature gradient (every device returns
    the whole one, dist_losses.py:283-285) equals the port's on each rank."""
    inputs = _inputs(world, "b4")
    mesh = create_mesh(data=world, model=1, devices=jax.devices()[:world])
    spec = P("data")
    got = jax.jit(shard_map(lambda i, t, T: jax.grad(lambda TT: jdl.ring_infonce_loss(i, t, TT))(T),
                            mesh=mesh, in_specs=(spec, spec, P()), out_specs=P()))(
        jnp.asarray(inputs["img"]), jnp.asarray(inputs["txt"]), jnp.float32(T0))
    _, _, _, scalars = _port(runs, world, "b4", "ring_infonce")
    for value in scalars["T"]:
        assert value == pytest.approx(float(got), rel=SCALAR_RTOL)
    whole = float(jax.grad(lambda T: contrastive_loss(jnp.asarray(inputs["img"]),
                                                      jnp.asarray(inputs["txt"]), T))(
        jnp.float32(T0)))
    assert abs(scalars["T"][0] - whole) < abs(whole) * (1 - 1 / world) / 2


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("loss_type", ROUTES)
@pytest.mark.parametrize("world", WORLDS)
def test_loss_route_matches_the_jax_loss_on_the_whole_batch(runs, world, loss_type, case):
    """The port's route over W ranks (rings for InfoNCE and uniformity,
    gathered lalign and SigLIP) against the JAX ``make_loss_fn`` on the
    whole batch: the loss, both embeddings' gradients and the scalars'."""
    inputs = _inputs(world, case)
    values, dimg, dtxt, scalars = _port(runs, world, case, f"route/{loss_type}")
    fn = jax_dispatch.make_loss_fn(loss_type)

    def loss(i, t, T, s, b):
        ctx = jax_dispatch.LossContext(temperature=T, beta=0.0, alpha=0.0, warm=False,
                                       logit_scale=s, logit_bias=b)
        return fn(i, t, ctx)[0]

    args = [jnp.asarray(inputs["img"]), jnp.asarray(inputs["txt"]), jnp.float32(T0),
            jnp.float32(SCALE0), jnp.float32(BIAS0)]
    want, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    assert len(set(values)) == 1, values
    assert values[0] == pytest.approx(float(want), rel=VALUE_RTOL)
    np.testing.assert_allclose(dimg, np.asarray(grads[0]), **GRAD_TOL)
    np.testing.assert_allclose(dtxt, np.asarray(grads[1]), **GRAD_TOL)
    for key, g in zip(("T", "scale", "bias"), grads[2:]):
        assert len(set(scalars[key])) == 1, scalars[key]
        assert scalars[key][0] == pytest.approx(float(g), rel=SCALAR_RTOL, abs=1e-7), key


def test_the_worker_imports_neither_jax_nor_the_jax_package(runs):
    """Each rank ran in a fresh interpreter on torch and the port alone."""
    source = open(torch_dp_worker.__file__).read()
    for bad in ("import jax", "from jax", "sparsify_clip_tpu.", "sparsify_clip_tpu "):
        assert bad not in source.replace("sparsify_clip_tpu_torch", ""), bad
    assert json.dumps(runs[2]["results"][0])  # the ranks wrote their results
