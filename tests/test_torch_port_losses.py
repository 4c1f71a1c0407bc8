"""The port's uniformity, alignment and centroid losses and its loss
dispatch against the JAX package's, on the CPU.

* The plain versions of the fused uniformity kernels
  (``lunif_fwd_reference``/``lunif_bwd_reference``) and autograd through
  ``LunifFunction`` against ``lunif_loss_pallas`` run in interpret mode
  (as tests/test_pallas_ops.py runs it) and against the XLA
  ``losses.unif.lunif_loss``, at N = 8 and at N = 200, which is no
  multiple of the TPU's 128-row tile.
* The helpers of ``losses/{unif,align,centroids}.py`` against JAX.
* Every ``loss_type``: value, the three aux components and the
  gradients of img, txt and the temperature against the JAX
  ``make_loss_fn`` on the same numpy embeddings, in both phases where
  the string has a warm phase; every context carries a row-stochastic
  soft-target matrix (``anchor-roberta``) and SigLIP's scale and bias.

The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_port_cuda_lunif.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sparsify_clip_tpu.losses import align as jax_align
from sparsify_clip_tpu.losses import centroids as jax_centroids
from sparsify_clip_tpu.losses import dispatch as jax_dispatch
from sparsify_clip_tpu.losses import unif as jax_unif
from sparsify_clip_tpu.ops.pallas_lunif import lunif_loss_pallas
from sparsify_clip_tpu_torch.losses import align, centroids, dispatch, unif
from sparsify_clip_tpu_torch.ops import lunif as ops_lunif
from sparsify_clip_tpu_torch.ops.lunif import (
    LunifFunction, lunif_bwd, lunif_bwd_reference, lunif_fwd, lunif_fwd_reference,
)

# fp32 on both sides: the same arithmetic, sums taken in other orders.
VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
D = 32


def _unit_rows(n, seed, d=D):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# ------------------------------------------------------------------ lunif


@pytest.mark.parametrize("n", [8, 200])
def test_lunif_plain_versions_match_the_pallas_kernel_and_the_xla_loss(n):
    x = _unit_rows(n, n)
    with pltpu.force_tpu_interpret_mode():
        k_loss, k_grad = jax.value_and_grad(lambda v: lunif_loss_pallas(v))(jnp.asarray(x))
    x_loss, x_grad = jax.value_and_grad(lambda v: jax_unif.lunif_loss(v))(jnp.asarray(x))

    tx = torch.from_numpy(x)
    s, loss = lunif_fwd_reference(tx)
    dx = lunif_bwd_reference(tx, s, torch.tensor(1.0))
    for want_loss, want_grad in ((k_loss, k_grad), (x_loss, x_grad)):
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        _close(dx, want_grad, GRAD)
    # S is the sum over the N(N-1) ordered pairs the loss averages
    assert float(s) == pytest.approx(float(np.exp(float(k_loss)) * n * (n - 1)), rel=1e-5)


@pytest.mark.parametrize("n", [8, 200])
def test_lunif_function_matches_the_pallas_kernel(n):
    """The loss as the dispatch calls it, with an incoming gradient other
    than 1, against jax.grad of the kernel."""
    x = _unit_rows(n, 100 + n)
    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grad = jax.value_and_grad(lambda v: 2.5 * lunif_loss_pallas(v))(
            jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = ops_lunif.lunif_loss(tx)
    (2.5 * loss).backward()
    assert 2.5 * float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    _close(tx.grad, want_grad, GRAD)


@pytest.mark.parametrize("n", [8, 200])
def test_plain_lunif_loss_and_distances_match_jax(n):
    x = _unit_rows(n, 200 + n) * 1.5  # off the sphere: the norms matter
    _close(unif.pairwise_sq_dists(torch.from_numpy(x)), jax_unif.pairwise_sq_dists(x),
           dict(rtol=1e-5, atol=1e-5))
    want_loss, want_grad = jax.value_and_grad(lambda v: jax_unif.lunif_loss(v, 1.5))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = unif.lunif_loss(tx, 1.5)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    _close(tx.grad, want_grad, GRAD)
    # the fused route at the same t
    s, fused = lunif_fwd_reference(tx.detach(), 1.5)
    assert float(fused) == pytest.approx(float(want_loss), rel=1e-5)
    _close(lunif_bwd_reference(tx.detach(), s, torch.tensor(1.0), 1.5), want_grad, GRAD)


def test_lunif_masks_the_diagonal_before_the_sum():
    """Far-apart rows: every off-diagonal weight underflows, and the loss
    is log(0) = -inf on both sides, not log of a cancelled N."""
    x = np.eye(4, dtype=np.float32) * 100.0
    assert float(jax_unif.lunif_loss(jnp.asarray(x))) == float("-inf")
    assert float(lunif_fwd_reference(torch.from_numpy(x))[1]) == float("-inf")
    assert float(unif.lunif_loss(torch.from_numpy(x))) == float("-inf")


def test_sparsify_loss_matches_jax():
    x = _unit_rows(12, 3)
    assert float(unif.sparsify_loss(torch.from_numpy(x))) == pytest.approx(
        float(jax_unif.sparsify_loss(jnp.asarray(x))), rel=1e-6)


def test_cpu_lunif_takes_the_plain_version_uncounted():
    tx = torch.from_numpy(_unit_rows(9, 4))
    before = (lunif_fwd.launches, lunif_bwd.launches)
    s, loss = lunif_fwd(tx)
    want_s, want_loss = lunif_fwd_reference(tx)
    g = torch.tensor(0.5)
    assert torch.equal(s, want_s) and torch.equal(loss, want_loss)
    assert torch.equal(lunif_bwd(tx, s, g), lunif_bwd_reference(tx, s, g))
    assert (lunif_fwd.launches, lunif_bwd.launches) == before
    with pytest.raises(ValueError, match="shape \\(N, D\\)"):
        lunif_fwd(tx[0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        lunif_fwd(tx.to("meta"))
    assert LunifFunction.apply(tx, 2.0).shape == ()


# ------------------------------------------------------------------ align


@pytest.mark.parametrize("alpha", [2.0, 3.0])
def test_lalign_loss_matches_jax(alpha):
    x, y = _unit_rows(10, 5), _unit_rows(10, 6)
    want, (gx, gy) = jax.value_and_grad(
        lambda a, b: jax_align.lalign_loss(a, b, alpha), argnums=(0, 1))(jnp.asarray(x),
                                                                        jnp.asarray(y))
    tx, ty = (torch.from_numpy(v).requires_grad_(True) for v in (x, y))
    loss = align.lalign_loss(tx, ty, alpha)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    _close(tx.grad, gx, GRAD)
    _close(ty.grad, gy, GRAD)


def test_lalign_gradient_is_defined_where_the_pair_coincides():
    """α = 2 is the mean of summed squares (PARITY.md:189): at x == y the
    gradient is 0, where norm().pow(2) gives 0/0."""
    x = torch.from_numpy(_unit_rows(4, 7)).requires_grad_(True)
    align.lalign_loss(x, x.detach().clone()).backward()
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_random_alignment_loss_is_lalign_against_the_generators_permutation():
    x, y = _unit_rows(10, 8), _unit_rows(10, 9)
    perm = torch.randperm(10, generator=torch.Generator().manual_seed(3))
    got = align.random_alignment_loss(torch.from_numpy(x), torch.from_numpy(y),
                                      torch.Generator().manual_seed(3))
    want = jax_align.lalign_loss(jnp.asarray(x), jnp.asarray(y[perm.numpy()]))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("p", [2, 3])
def test_centroid_alignment_loss_matches_jax(p):
    x, y = _unit_rows(10, 10), _unit_rows(10, 11)
    want = jax_align.centroid_alignment_loss(jnp.asarray(x), jnp.asarray(y), p)
    got = align.centroid_alignment_loss(torch.from_numpy(x), torch.from_numpy(y), p)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# ------------------------------------------------------------------ centroids


def test_centroid_helpers_match_jax():
    x, y = _unit_rows(6, 12), _unit_rows(6, 13)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want_norms, want_c = jax_centroids.compute_centroids(jnp.asarray(x), jnp.asarray(y))
    got_norms, got_c = centroids.compute_centroids(tx, ty)
    assert got_c.shape == (6, 6, D)
    _close(got_c, want_c, VALUE)
    _close(got_norms, want_norms, VALUE)
    _close(centroids.compute_centroids_only(tx, ty),
           jax_centroids.compute_centroids_only(jnp.asarray(x), jnp.asarray(y)), VALUE)


def test_normalized_centroids_match_jax_with_their_gradient():
    x, y = _unit_rows(6, 14), _unit_rows(6, 15)

    def jax_fn(a, b):
        return jnp.sum(jax_centroids.normalized_centroids(a, b) * jnp.arange(D))

    want_c = jax_centroids.normalized_centroids(jnp.asarray(x), jnp.asarray(y))
    gx, gy = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(v).requires_grad_(True) for v in (x, y))
    c = centroids.normalized_centroids(tx, ty)
    (c * torch.arange(D)).sum().backward()
    _close(c, want_c, VALUE)
    _close(tx.grad, gx, GRAD)
    _close(ty.grad, gy, GRAD)


def test_normalized_centroids_clamp_a_zero_midpoint():
    """A zero midpoint stays zero (the norm clamped at 1e-12, as
    F.normalize) on both sides, where a plain divide gives nan."""
    x = _unit_rows(3, 16)
    y = -x
    y[1:] = x[1:]
    want = np.asarray(jax_centroids.normalized_centroids(jnp.asarray(x), jnp.asarray(y)))
    got = centroids.normalized_centroids(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want, VALUE)
    assert float(got[0].abs().max()) == 0.0 and np.isfinite(want).all()


# ------------------------------------------------------------------ dispatch

RUNNABLE = list(dispatch._DISPATCH)
PHASES = [(lt, warm) for lt in RUNNABLE
          for warm in ((False, True) if jax_dispatch._DISPATCH[lt][1] else (False,))]
N_PAIRS, TEMP, BETA, ALPHA = 24, 0.1, 0.7, 1.3
SCALE, BIAS = 10.0, -10.0  # SigLIP's paper inits


def _soft_targets():
    logits = np.random.default_rng(24).standard_normal((N_PAIRS, N_PAIRS)).astype(np.float32)
    e = np.exp(2.0 * logits)
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX ``make_loss_fn`` of every phase on the same embeddings, with
    the gradients of img, txt and T, under one ``jax.jit`` (one compile for
    all of them, as the train step compiles its loss)."""
    img, txt = _unit_rows(N_PAIRS, 20), _unit_rows(N_PAIRS, 21)

    def one(loss_type, warm):
        fn = jax_dispatch.make_loss_fn(loss_type)

        def f(i, t, temp):
            ctx = jax_dispatch.LossContext(temperature=temp, beta=jnp.float32(BETA),
                                           alpha=jnp.float32(ALPHA), warm=jnp.array(warm),
                                           soft_targets=jnp.asarray(_soft_targets()),
                                           logit_scale=jnp.float32(SCALE),
                                           logit_bias=jnp.float32(BIAS))
            return fn(i, t, ctx)

        return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)

    out = jax.jit(lambda i, t, temp: [one(lt, warm)(i, t, temp) for lt, warm in PHASES])(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(TEMP))
    return img, txt, {
        phase: (float(loss), {k: float(v) for k, v in aux.items()}, [np.asarray(g) for g in grads])
        for phase, ((loss, aux), grads) in zip(PHASES, out)}


def _port_loss(loss_type, img, txt, warm):
    ti, tt = (torch.from_numpy(v).requires_grad_(True) for v in (img, txt))
    temp = torch.tensor(TEMP, requires_grad=True)
    ctx = dispatch.LossContext(temperature=temp, beta=BETA, alpha=ALPHA, warm=warm,
                               soft_targets=torch.from_numpy(_soft_targets()),
                               logit_scale=torch.tensor(SCALE), logit_bias=torch.tensor(BIAS))
    loss, aux = dispatch.make_loss_fn(loss_type)(ti, tt, ctx)
    loss.backward()
    grads = [v.grad if v.grad is not None else torch.zeros_like(v) for v in (ti, tt, temp)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


@pytest.mark.parametrize("loss_type,warm", PHASES)
def test_loss_type_matches_the_jax_loss(jax_losses, loss_type, warm):
    img, txt, want = jax_losses
    want_loss, want_aux, want_grads = want[loss_type, warm]
    loss, aux, grads = _port_loss(loss_type, img, txt, warm)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert set(aux) == set(want_aux) == {"anchor", "lalign", "lunif"}
    for k in aux:
        assert float(aux[k]) == pytest.approx(want_aux[k], rel=1e-5, abs=1e-7), k
    for got, want in zip(grads, want_grads):
        _close(got, want, GRAD)
    if warm:  # the warm phase is pure uniformity: nothing reaches T
        assert float(grads[2]) == 0.0 and float(aux["anchor"]) == 0.0


def test_exp7_and_exp8_run_the_per_modality_branch_bit_for_bit():
    """Experiments 7 and 8 share one loss_type string, and both run the
    reference's first (per-modality) branch; the centroid branch they name
    is reachable only as ``__dead__…``."""
    img, txt = _unit_rows(N_PAIRS, 22), _unit_rows(N_PAIRS, 23)
    exp78 = "only_lunif_n_then_anchor+lalign+BETA*lunif(centroids)"
    exp7, exp8 = (_port_loss(exp78, img, txt, False) for _ in range(2))
    assert torch.equal(exp7[0], exp8[0])
    assert all(torch.equal(a, b) for a, b in zip(exp7[2], exp8[2]))
    assert all(torch.equal(exp7[1][k], exp8[1][k]) for k in exp7[1])
    ti, tt = torch.from_numpy(img), torch.from_numpy(txt)
    ctx = dispatch.LossContext(temperature=torch.tensor(TEMP), beta=BETA)
    per_modality, _ = dispatch._anchor_lalign_beta_lunif_modality(ti, tt, ctx)
    dead, _ = dispatch.make_loss_fn("__dead__anchor+lalign+BETA*lunif(centroids)")(ti, tt, ctx)
    assert torch.equal(exp7[0], per_modality) and abs(float(dead - per_modality)) > 1e-4


def test_uniformity_always_goes_through_the_fused_lunif(monkeypatch):
    """On any device the dispatch's uniformity is ``ops.lunif.lunif_loss``
    (its kernels on the card, plain versions here)."""
    calls = []

    def spy(x, t=2.0):
        calls.append(tuple(x.shape))
        return ops_lunif.lunif_loss(x, t)

    monkeypatch.setattr(dispatch, "lunif_loss", spy)
    ti, tt = torch.from_numpy(_unit_rows(6, 24)), torch.from_numpy(_unit_rows(6, 25))
    ctx = dispatch.LossContext(temperature=torch.tensor(TEMP), warm=True)
    fn = dispatch.make_loss_fn("only_lunif_n_then_anchor+lalign+lunif(centroids)")
    warm_loss, _ = fn(ti, tt, ctx)
    ctx.warm = False
    fn(ti, tt, ctx)
    assert calls == [(6, D)] * 3  # img and txt when warm, the centroids after
    want = (unif.lunif_loss(ti) + unif.lunif_loss(tt)) / 2
    torch.testing.assert_close(warm_loss, want, rtol=1e-6, atol=1e-6)
