"""Full-width ViT-L-14-336 through the port against the JAX package, on
the CPU, cut in depth to one vision and one text layer.

The widths are ViT-L-14-336's (vision 1024 wide, 16 heads, patch 14, 336²
images, 577 tokens; text 768 wide, 12 heads, 77 tokens; embed 768), so the
vision tower takes the head-group route in both fp32 (7.09 MB of qkv a
sample) and bf16 (3.54 MB), and the text tower the whole-width route.  The
JAX side runs attention through its einsum path on the CPU; the port runs
its head-group plain versions (the kernels' CPU path).

* a 3-step exp-6 lockstep at batch 2 in fp32 compute, with
  ``steps_per_epoch=2``: two warm steps, then one main step, against the
  JAX ``create_train_setup`` + ``train_step``, with the tolerances of
  tests/test_torch_port_exp6.py;
* the bf16 encode of both towers against the JAX encode, with the
  tolerance of tests/test_torch_port_models.py;
* the fp32 eval twin's 13 metrics over 8 pairs against the JAX
  ``evaluate_model``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu import eval as jax_eval
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch import eval as port_eval
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.ops import attention
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_exp6 import COMPONENTS
from test_torch_port_models import BF16_ATOL, token_rows
from test_torch_port_train import _two_tier

NAME = "vitl336-depth1-test"
for _registry in (jax_clip.MODEL_REGISTRY, port_clip.MODEL_REGISTRY):
    _registry.setdefault(NAME, dataclasses.replace(
        _registry["ViT-L-14-336"], name=NAME, vision_layers=(1,), text_layers=1))
B, STEPS, SPE, LR = 2, 3, 2, 1e-3
SIZE = 336
EXP6 = dict(model=NAME, batch_size=B, epochs=2, learning_rate=LR, fp16=False,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
            anchor_temperature=0.1, seed=0)


def test_the_depth_cut_keeps_the_l336_widths_and_routes():
    cfg = port_clip.MODEL_REGISTRY[NAME]
    full = port_clip.MODEL_REGISTRY["ViT-L-14-336"]
    assert dataclasses.replace(cfg, name=full.name, vision_layers=(24,), text_layers=12) == full
    assert attention.use_head_group(577, 3 * cfg.vision_width, 4, cfg.vision_heads)
    assert attention.use_head_group(577, 3 * cfg.vision_width, 2, cfg.vision_heads)
    assert not attention.use_head_group(77, 3 * cfg.text_width, 4, cfg.text_heads)


@pytest.fixture(scope="module")
def exp6_runs():
    """The same 3 steps through the JAX step and the port's step, and the
    launches the port's plain head-group versions stood in for."""
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(EXP6),
                                    steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(EXP6),
                               steps_per_epoch=SPE, device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state = jsetup.state, setup.state
    jax_log, port_log = [], []
    for step in range(STEPS):
        batch = synthetic_batch(B, SIZE, seed=40 + step)
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        jax_log.append({k: float(v) for k, v in jm.items()})
        port_log.append({k: float(v) for k, v in pm.items()})
    return dict(jax=jax_log, port=port_log, jax_final=collect_host_arrays(jstate.params),
                params=dict(state.model.named_parameters()), model=setup.model)


def test_exp6_lockstep_across_the_warm_phase_boundary(exp6_runs):
    jax_log, port_log = exp6_runs["jax"], exp6_runs["port"]
    for step, (want, got) in enumerate(zip(jax_log, port_log)):
        for key in COMPONENTS:
            assert got[key] == pytest.approx(want[key], rel=5e-4, abs=1e-7), (step, key)
        warm = step < SPE
        assert (got["anchor"] == 0.0 and got["lalign"] == 0.0) == warm, step
        assert np.isfinite(got["train_loss"])


def test_exp6_lockstep_final_parameters(exp6_runs):
    _two_tier(exp6_runs["params"], exp6_runs["jax_final"], tight_frac=0.999, cap=2 * LR * STEPS)


def test_the_port_model_trains_fp32_with_the_l336_shapes(exp6_runs):
    model = exp6_runs["model"]
    assert model.visual.positional_embedding.shape == (577, 1024)
    assert model.text.positional_embedding.shape == (77, 768)
    assert model.visual.proj.shape == (1024, 768) and model.text.text_projection.shape == (768, 768)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.fixture(scope="module")
def jax_pair():
    """(bf16 flax model, its variables, their flat weights): what
    ``jax_clip.create_model(NAME, jnp.bfloat16)`` returns, init jitted."""
    jmodel = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY[NAME], dtype=jnp.bfloat16)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 77), jnp.int32),
        train=False)
    return jmodel, variables, collect_host_arrays(variables["params"])


@pytest.mark.parametrize("tower", ["image", "text"])
def test_bf16_encode_matches_jax(jax_pair, tower):
    jmodel, variables, flat = jax_pair
    port = load_jax_params(port_clip.create_model(NAME, dtype=torch.bfloat16, device="cpu"), flat)
    if tower == "image":
        x = synthetic_batch(2, SIZE, seed=17)["images"]
        method, encode = jax_clip.CLIP.encode_image, port.encode_image
    else:
        x = token_rows(2, 77, 49408, seed=19)
        method, encode = jax_clip.CLIP.encode_text, port.encode_text
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method=method))(variables, x))
    with torch.no_grad():
        got = encode(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 768)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL * np.abs(want).max())


def test_fp32_eval_twin_matches_the_jax_eval(jax_pair):
    jmodel, variables, flat = jax_pair
    batches = [synthetic_batch(4, SIZE, seed=s) for s in (30, 31)]  # 8 pairs
    want = jax_eval.evaluate_model(jax_eval.make_eval_model(jmodel), variables, batches)
    model = port_clip.create_model(NAME, dtype=torch.bfloat16, device="cpu",
                                   param_dtype=torch.float32).train()
    load_jax_params(model, flat)
    twin = port_eval.make_eval_model(model)
    assert twin.dtype == torch.float32
    got = port_eval.evaluate_model(twin, batches)
    assert set(got) == set(want) and len(got) == 13
    for key, value in want.items():
        # fp32 towers on both sides: the same ranks, and the 4-decimal
        # values up to one rounding step
        assert got[key] == pytest.approx(value, abs=1e-4 + 1e-12), key
