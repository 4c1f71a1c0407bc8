"""The port's fused LayerNorm + qkv projection against the JAX package's,
on the CPU.

* the plain version :func:`ln_qkv_reference` against ``ln_qkv_pallas``
  run in interpret mode (the TPU kernel's own arithmetic) and against the
  JAX twin ``ln_qkv_reference``: fp32 and bf16, 300 rows (no multiple of
  any tile), W of 64 and 768 and, at few rows, 1280, and rows whose mean
  is ten times their spread, where the fast variance E[x²] − E[x]² that
  both sides take is furthest from an exact one;
* the row-statistics plain version :func:`row_stats_reference` (the
  kernels' first pass) against the JAX twin's mean and fast variance at
  ragged widths, and the backward's LayerNorm wrapper :func:`ln_fast_bwd`
  giving a CPU tensor its plain version, uncounted;
* :class:`LnQkvFunction`'s five gradients against ``jax.grad`` of
  ``ln_qkv_pallas`` in interpret mode, and against autograd of the plain
  version, so the written-out backward is the twin's gradient;
* a fused ``ResidualAttentionBlock`` against the JAX fused block
  (``force_pallas_ln_qkv`` + interpret mode) on the same weights through
  ``load_jax_params``, with the unfused block's ``state_dict`` keys;
* ``CLIP.with_dtype`` and the fp32 eval twin keep the flag;
* a 3-step exp-6 lockstep with ``fused_ln_qkv: true`` across the
  warm→main boundary against the JAX step, at ViT-L-14-336's widths cut
  to one layer a tower (as tests/test_torch_port_vitl336.py), and a warm
  and a main step of ``tiny-test`` in bf16 compute (longer bf16 runs
  drift apart by their rounding, fused or not).

Tolerances: fp32 1e-5 (the two sides sum the statistics and the product
in other orders), bf16 2e-2 (one bf16 rounding step of the output, as
tests/test_pallas_ln_qkv.py), gradients rtol 1e-4 / atol 1e-5 (as there),
the atol against each gradient's largest entry: dW sums 300 rows of
terms up to ~100 in another order than XLA's and has entries that cancel
to ~0.04 (measured 4e-5 apart on a largest entry of 150).
On rows shifted by s standard deviations the fast variance cancels: the
sums' order-dependent rounding reaches the variance multiplied by
E[x²]/var = 1 + s², so the fp32 tolerance there is 1e-5·(1 + s²) (1e-3 at
s = 10; measured 1.1e-4 at W 64).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.models.layers import ResidualAttentionBlock as JaxBlock
from sparsify_clip_tpu.ops.pallas_ln_qkv import (
    force_pallas_ln_qkv, ln_qkv_pallas, ln_qkv_reference as jax_ln_qkv_reference,
)
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch import eval as port_eval
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.models.layers import ResidualAttentionBlock, gelu_exact
from sparsify_clip_tpu_torch.ops import ln_qkv as port_ln_qkv
from sparsify_clip_tpu_torch.ops.ln_qkv import (
    LnQkvFunction, ln_fast_bwd, ln_fast_bwd_reference, ln_qkv_core, ln_qkv_fwd,
    ln_qkv_reference, row_stats_reference,
)
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_exp6 import COMPONENTS
from test_torch_port_train import _two_tier

EPS = 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD = (1e-4, 1e-5)  # rtol, atol relative to the largest entry
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, w, seed=11, shift=0.0):
    """x (N, W), LayerNorm scale and bias (W,), the JAX kernel (W, 3W) and
    the in_proj bias (3W,), fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, w)).astype(np.float32) + np.float32(shift)
    scale = (1.0 + 0.1 * rng.standard_normal(w)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(w)).astype(np.float32)
    kernel = (rng.standard_normal((w, 3 * w)) * w ** -0.5).astype(np.float32)
    kbias = (0.1 * rng.standard_normal(3 * w)).astype(np.float32)
    return x, scale, bias, kernel, kbias


def _port_args(x, scale, bias, kernel, kbias, dtype):
    """The port's arguments: x in ``dtype``, the in_proj weight (3W, W)."""
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(np.ascontiguousarray(kernel.T)), torch.from_numpy(kbias))


CASES = [(300, 64, 0.0), (300, 768, 0.0), (20, 1280, 0.0), (300, 64, 10.0), (300, 768, 10.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,w,shift", CASES)
def test_plain_version_matches_the_jax_kernel_and_twin(n, w, shift, dtype):
    jdt, tdt = DTYPES[dtype]
    x, scale, bias, kernel, kbias = _inputs(n, w, shift=shift)
    args = (jnp.asarray(x, jdt), scale, bias, kernel, kbias)
    with pltpu.force_tpu_interpret_mode():
        kernel_out = jax.jit(lambda *a: ln_qkv_pallas(*a, EPS, jdt))(*args)
    twin_out = jax_ln_qkv_reference(*args, EPS, jdt)
    got = ln_qkv_reference(*_port_args(x, scale, bias, kernel, kbias, tdt), EPS, tdt)
    assert got.dtype == tdt and got.shape == (n, 3 * w)
    tol = TOL[dtype] * (1.0 + shift ** 2 if dtype == "float32" else 1.0)
    for want in (kernel_out, twin_out):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("n,w", [(256, 128), (300, 64)])
def test_function_gradients_match_jax_grad(n, w):
    x, scale, bias, kernel, kbias = _inputs(n, w, seed=3)

    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jnp.square(ln_qkv_pallas(*a, EPS, jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), scale, bias, kernel, kbias)
    leaves = [t.requires_grad_(True)
              for t in _port_args(x, scale, bias, kernel, kbias, torch.float32)]
    out = LnQkvFunction.apply(*leaves, EPS, torch.float32)
    (out ** 2).sum().backward()
    got = [t.grad.numpy() for t in leaves]
    got[3] = got[3].T  # the port's weight is (3W, W)
    for name, g, wg in zip(("dx", "dscale", "dbias", "dweight", "dkbias"), got, want):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g, wg, rtol=GRAD[0], atol=GRAD[1] * np.abs(wg).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_is_autograd_of_the_plain_version(dtype):
    """The written-out backward (y recomputed, no second product) gives
    what autograd of the plain version gives, in the types of the unfused
    path: fp32 parameters get fp32 gradients, x one in its own type."""
    x, scale, bias, kernel, kbias = _inputs(96, 64, seed=5, shift=2.0)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((96, 192)).astype(np.float32))
    grads = []
    for fn in (lambda *a: LnQkvFunction.apply(*a, EPS, dtype),
               lambda *a: ln_qkv_reference(*a, EPS, dtype)):
        leaves = [t.requires_grad_(True) for t in _port_args(x, scale, bias, kernel, kbias, dtype)]
        fn(*leaves).backward(g.to(dtype))
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(("dx", "dscale", "dbias", "dweight", "dkbias"), *grads):
        assert got.dtype == want.dtype, name
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
    assert grads[0][0].dtype == dtype and grads[0][3].dtype == torch.float32


def test_function_saves_its_inputs_and_no_output():
    leaves = [t.requires_grad_(True)
              for t in _port_args(*_inputs(40, 64), torch.bfloat16)]
    out = ln_qkv_core(leaves[0].view(2, 20, 64), *leaves[1:], EPS)
    assert out.shape == (2, 20, 192) and out.dtype == torch.bfloat16
    fn = out.grad_fn.next_functions[0][0]
    assert type(fn).__name__ == "LnQkvFunctionBackward"
    saved = fn.saved_tensors
    assert len(saved) == 5 and all(a is b for a, b in zip(saved[1:], leaves[1:]))
    with torch.no_grad():
        assert torch.equal(ln_qkv_core(leaves[0].view(2, 20, 64), *leaves[1:], EPS), out)


def test_cpu_tensors_take_the_plain_version_uncounted():
    args = _port_args(*_inputs(40, 64), torch.float32)
    before = ln_qkv_fwd.launches
    assert torch.equal(ln_qkv_fwd(*args, EPS), ln_qkv_reference(*args, EPS))
    assert ln_qkv_fwd.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0.0, 3.0])
@pytest.mark.parametrize("w", [8, 72, 520, 1408])
def test_row_stats_plain_version_matches_the_jax_twin(w, shift, dtype):
    """The kernels' first pass takes each row's mean and rsqrt(E[x²] −
    E[x]² + eps) as the twin does (pallas_ln_qkv.py:111-113); fp32 sums of
    W terms in other orders, the variance's cancellation on rows shifted
    by s standard deviations growing as 1 + s²."""
    jdt, tdt = DTYPES[dtype]
    x = _inputs(33, w, seed=12, shift=shift)[0]
    x32 = jnp.asarray(x, jdt).astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(x32 * x32, axis=-1, keepdims=True) - mean * mean
    want = np.concatenate([np.asarray(mean), np.asarray(jax.lax.rsqrt(var + EPS))], axis=-1)
    got = row_stats_reference(torch.from_numpy(x).to(tdt), EPS)
    assert got.dtype == torch.float32 and got.shape == (33, 2)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 1].numpy(), want[:, 1], rtol=1e-5 * (1 + shift ** 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_takes_the_plain_version_uncounted(dtype):
    x, scale, bias = _port_args(*_inputs(40, 64, shift=1.0), dtype)[:3]
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal((40, 64)).astype(np.float32))
    before = ln_fast_bwd.launches
    got = ln_fast_bwd(x, dy.to(dtype), scale, bias, EPS)
    want = ln_fast_bwd_reference(x, dy.to(dtype), scale, bias, EPS)
    assert ln_fast_bwd.launches == before
    assert [t.dtype for t in got] == [dtype, dtype, torch.float32, torch.float32]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_other_devices_raise():
    meta = [t.to("meta") for t in _port_args(*_inputs(8, 64), torch.float32)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ln_qkv_fwd(*meta, EPS)


def _random_params(params, seed):
    """Every leaf of a flax param tree redrawn from a numpy seed, so the
    LayerNorm and the biases are not at their init of 1 and 0."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((0.5 * rng.standard_normal(a.shape) + (np.asarray(a) == 1))
                              .astype(np.float32)
                              * (1.0 if a.ndim == 1 else a.shape[0] ** -0.5)), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_matches_the_jax_fused_block(dtype, causal):
    jdt, tdt = DTYPES[dtype]
    width, heads = 64, 2
    x = np.random.default_rng(7).standard_normal((2, 10, width)).astype(np.float32) + 1.5
    kw = dict(width=width, heads=heads, dtype=jdt, causal=causal)
    params = _random_params(JaxBlock(**kw).init(jax.random.PRNGKey(0), jnp.asarray(x, jdt)), 8)
    with force_pallas_ln_qkv(), pltpu.force_tpu_interpret_mode():
        want = np.asarray(JaxBlock(fused_ln_qkv=True, **kw).apply(params, jnp.asarray(x, jdt)),
                          np.float32)
    fused = ResidualAttentionBlock(width, heads, None, gelu_exact, causal, fused_ln_qkv=True)
    unfused = ResidualAttentionBlock(width, heads, None, gelu_exact, causal)
    assert list(fused.state_dict()) == list(unfused.state_dict())
    load_jax_params(fused, collect_host_arrays(params["params"]))
    with torch.no_grad():
        got = fused(torch.from_numpy(x).to(tdt)).float().numpy()
    scale = np.abs(want).max()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_fused_block_routes_through_the_fused_op(monkeypatch):
    calls = []
    real = port_ln_qkv.ln_qkv_core
    from sparsify_clip_tpu_torch.models import layers

    monkeypatch.setattr(layers, "ln_qkv_core", lambda *a: calls.append(a) or real(*a))
    block = ResidualAttentionBlock(32, 2, None, gelu_exact, False, fused_ln_qkv=True)
    torch.nn.init.normal_(block.attn.in_proj_weight)
    torch.nn.init.normal_(block.attn.out_proj.weight)
    block(torch.zeros(2, 5, 32).normal_())
    assert len(calls) == 1
    x, scale, bias, weight, kbias, eps = calls[0]
    assert scale is block.ln_1.weight and bias is block.ln_1.bias
    assert weight is block.attn.in_proj_weight and kbias is block.attn.in_proj_bias
    assert eps == block.ln_1.eps and x.dtype == torch.float32


def test_with_dtype_and_the_eval_twin_keep_the_flag():
    model = port_clip.create_model("tiny-test", dtype=torch.bfloat16, device="cpu",
                                   param_dtype=torch.float32, fused_ln_qkv=True).train()
    twin = model.with_dtype(torch.float32)
    evaluated = port_eval.make_eval_model(model)
    for m in (model, twin, evaluated):
        assert m.fused_ln_qkv
        blocks = [b for b in m.modules() if isinstance(b, ResidualAttentionBlock)]
        assert len(blocks) == 4 and all(b.fused_ln_qkv for b in blocks)
    assert twin.dtype == evaluated.dtype == torch.float32
    assert not port_clip.create_model("tiny-test", device="cpu").fused_ln_qkv
    unfused = port_clip.create_model("tiny-test", device="cpu")
    assert list(unfused.state_dict()) == list(model.state_dict())


def test_fused_and_unfused_towers_agree_in_fp32():
    """The same weights through both block kinds: the fused LayerNorm's
    fast variance and the unfused one's exact variance meet at fp32
    rounding on unshifted rows."""
    fused = port_clip.create_model("tiny-test", device="cpu", seed=3, fused_ln_qkv=True)
    unfused = port_clip.create_model("tiny-test", device="cpu", seed=3)
    batch = synthetic_batch(4, 32, seed=2)
    with torch.no_grad():
        for a, b in zip(fused(torch.from_numpy(batch["images"]), torch.from_numpy(batch["tokens"])),
                        unfused(torch.from_numpy(batch["images"]),
                                torch.from_numpy(batch["tokens"]))):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# --- exp-6 locksteps with fused_ln_qkv: true --------------------------------

NAME = "vitl336-depth1-fused-test"
for _registry in (jax_clip.MODEL_REGISTRY, port_clip.MODEL_REGISTRY):
    _registry.setdefault(NAME, dataclasses.replace(
        _registry["ViT-L-14-336"], name=NAME, vision_layers=(1,), text_layers=1))
EXP6 = dict(epochs=2, loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)",
            only_lunif_epochs=1, anchor_temperature=0.1, seed=0, fused_ln_qkv=True)
LOCKSTEPS = {
    # name → (fields, steps, steps_per_epoch, image size, loss rel tolerance)
    "l336_fp32": (dict(EXP6, model=NAME, batch_size=2, learning_rate=1e-3, fp16=False),
                  3, 2, 336, 5e-4),
    "tiny_bf16": (dict(EXP6, model="tiny-test", batch_size=8, learning_rate=1e-3, fp16=True),
                  2, 1, 32, 3e-2),  # test_torch_port_exp6.py's bf16 bound
}


@pytest.fixture(scope="module", params=sorted(LOCKSTEPS))
def fused_runs(request):
    fields, steps, spe, size, rel = LOCKSTEPS[request.param]
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                    steps_per_epoch=spe, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                               steps_per_epoch=spe, device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state = jsetup.state, setup.state
    jax_log, port_log = [], []
    before = ln_qkv_fwd.launches
    for step in range(steps):
        batch = synthetic_batch(fields["batch_size"], size, seed=40 + step)
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        jax_log.append({k: float(v) for k, v in jm.items()})
        port_log.append({k: float(v) for k, v in pm.items()})
    return dict(name=request.param, jax=jax_log, port=port_log, spe=spe, rel=rel,
                lr=fields["learning_rate"], steps=steps, model=setup.model,
                jax_final=collect_host_arrays(jstate.params),
                params=dict(state.model.named_parameters()),
                launches=ln_qkv_fwd.launches - before)


def test_fused_exp6_lockstep_across_the_warm_phase_boundary(fused_runs):
    model = fused_runs["model"]
    assert model.fused_ln_qkv and fused_runs["launches"] == 0  # CPU: the plain version
    for step, (want, got) in enumerate(zip(fused_runs["jax"], fused_runs["port"])):
        for key in COMPONENTS:
            assert got[key] == pytest.approx(want[key], rel=fused_runs["rel"], abs=1e-7), \
                (step, key)
        warm = step < fused_runs["spe"]
        assert (got["anchor"] == 0.0 and got["lalign"] == 0.0) == warm, step
        assert np.isfinite(got["train_loss"])


def test_fused_exp6_lockstep_final_parameters(fused_runs):
    lr, steps = fused_runs["lr"], fused_runs["steps"]
    tight = 0.999 if fused_runs["name"] == "l336_fp32" else 0.85  # as test_torch_port_exp6.py
    _two_tier(fused_runs["params"], fused_runs["jax_final"], tight_frac=tight, cap=2 * lr * steps)
