"""The registry towers that had not run at full width on the card, in the
port, on the CPU, against the JAX package.

* **Keys and shapes** of ViT-B-16, the ViT ``-quickgelu`` names and
  ViT-bigG-14 at full width: every parameter of the port's model (built on
  the meta device) maps onto the JAX ``jax.eval_shape`` key of the same
  shape (``checkpoints.jax_paths``), and the parameter counts are equal.
  The ViT twin of tests/test_torch_port_resnet.py's
  ``test_resnet_keys_and_shapes_equal_the_jax_models``.
* **Locksteps**: 3 exp-6 steps across the warm→main boundary (steps 0-1
  warm, step 2 main) at exp 6's learning rate (1e-4, scripts/_bench.py:81-87,
  as ``chip_smoke.py`` phases 47-49 train) against the JAX step on one
  device, from numpy weights drawn from a seed over the JAX variables'
  shapes and carried across by ``load_jax_params``, fp32 compute: losses
  rel 1e-4, the held-out batch's embeddings rtol 2e-3, atol 5e-5
  (tests/test_torch_port_large_towers.py's tolerances).  ``bigG-twin``
  (tests/test_torch_port_large_towers_rank.py: ViT-bigG-14's head_dims and
  MLP ratio) under ViT-bigG-14's training knobs, ``remat: true`` with
  ``adam_mu_dtype: bfloat16``; a narrow patch-16 ``-quickgelu`` ViT (quick
  GELU's gradient in the step); an RN50x64-shaped ResNet under remat
  (attention-pool heads of 64 lanes, width·32/64, and a 2×2 positional
  grid, not 7×7), whose losses are held at rel 5e-4, the port's RN50
  lockstep's tolerance (tests/test_torch_port_rn50.py): a train-mode
  BatchNorm's fp32 gradient is percent-level rounding noise in both
  frameworks against float64, and Adam's first steps walk each such
  coordinate by ±lr (step 2 read 1.6e-4 here).
* ``AdamWBf16Mu`` over slices of its parameter list equals the update
  over the whole list to the bit.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import checkpoints, optim
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_large_towers_rank import register_twins

FULL_WIDTH = ("ViT-B-16", "ViT-B-32-quickgelu", "ViT-B-16-quickgelu", "ViT-L-14-quickgelu",
              "ViT-L-14-336-quickgelu", "ViT-bigG-14")
B, SPE, STEPS, CONTEXT, VOCAB = 16, 2, 3, 12, 256
EMBED_RTOL, EMBED_ATOL = 2e-3, 5e-5
EXP6 = dict(batch_size=B, epochs=2, learning_rate=1e-4, seed=0, fp16=False,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1)
_NARROW_TEXT = dict(vocab_size=VOCAB, context_length=CONTEXT, text_width=32, text_heads=2,
                    text_layers=1)
for _registry, _config in ((jax_clip.MODEL_REGISTRY, jax_clip.CLIPConfig),
                           (port_clip.MODEL_REGISTRY, port_clip.CLIPConfig)):
    register_twins(_registry, _config)
    _registry.setdefault("b16-quickgelu-twin", dataclasses.replace(
        _registry["ViT-B-16-quickgelu"], name="b16-quickgelu-twin", embed_dim=32,
        image_size=32, vision_width=64, vision_layers=(1,), vision_heads=2, **_NARROW_TEXT))
    # RN50x64: width 128, attention pool of 128·32 / 64 heads, 448 / 32 = 14
    _registry.setdefault("rn50x64-twin", dataclasses.replace(
        _registry["RN50x64"], name="rn50x64-twin", embed_dim=32, image_size=64, vision_width=8,
        vision_layers=(1, 1, 1, 1), vision_heads=8 * 32 // 64, **_NARROW_TEXT))
# each twin's knobs and its losses' relative tolerance
LOCKSTEPS = {
    "bigG-twin": (dict(remat=True, adam_mu_dtype="bfloat16"), 1e-4),
    "b16-quickgelu-twin": ({}, 1e-4),
    "rn50x64-twin": (dict(remat=True), 5e-4),
}


@pytest.mark.parametrize("name", FULL_WIDTH)
def test_vit_keys_shapes_and_count_equal_the_jax_models(name):
    cfg = jax_clip.MODEL_REGISTRY[name]
    model = jax_clip.CLIP(cfg=cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
        jnp.zeros((1, cfg.context_length), jnp.int32), train=False))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = {"/".join(k.key for k in path): leaf.shape for path, leaf in leaves}
    assert dataclasses.asdict(port_clip.MODEL_REGISTRY[name]) == dataclasses.asdict(cfg)
    with torch.device("meta"):
        port = port_clip.CLIP(port_clip.MODEL_REGISTRY[name])
    params = dict(port.named_parameters())
    got = {path: fn(np.broadcast_to(np.float32(0), tuple(params[n].shape))).shape
           for n, (path, fn) in checkpoints.jax_paths(port).items()}
    assert got == want
    assert sum(p.numel() for p in params.values()) == sum(
        int(np.prod(s)) for s in want.values())


def _batch(seed: int, size: int) -> dict:
    """tests/torch_layouts.py's batch (the JAX test's) at ``size`` px."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB - 6, size=(B, CONTEXT)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = VOCAB - 2, VOCAB - 1
    return {"images": rng.standard_normal((B, size, size, 3)).astype(np.float32),
            "tokens": tokens}


@contextlib.contextmanager
def _numpy_flax_init(seed: int):
    """The JAX ``create_model``'s ``model.init`` replaced by numpy draws
    from ``seed`` over the variables' shapes (``jax.eval_shape``: no init
    is compiled): LayerNorm and BatchNorm scales 1 + 0.1·N(0, 1), every
    other parameter 0.05·N(0, 1), running means 0 and variances 1."""
    init = jax_clip.CLIP.init

    def drawn(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r, *a: init(self, r, *a, **kwargs), rngs, *args)
        rng = np.random.default_rng(seed)

        def draw(path, leaf):
            key = path[-1].key
            if path[0].key == "batch_stats":
                value = np.full(leaf.shape, 1.0 if key == "var" else 0.0)
            elif key == "scale":
                value = 1 + 0.1 * rng.standard_normal(leaf.shape)
            else:
                value = 0.05 * rng.standard_normal(leaf.shape)
            return jnp.asarray(value, jnp.float32)

        return jax.tree_util.tree_map_with_path(draw, shapes)

    jax_clip.CLIP.init = drawn
    try:
        yield
    finally:
        jax_clip.CLIP.init = init


def _jax_run(name: str) -> dict:
    """The JAX step's lockstep of ``name`` on one device: its initial
    variables, each step's loss, the held-out batch's embeddings."""
    fields = dict(EXP6, model=name, **LOCKSTEPS[name][0])
    size = jax_clip.MODEL_REGISTRY[name].image_size
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                    steps_per_epoch=SPE, mesh=mesh)
    state = jsetup.state
    run = dict(params=collect_host_arrays(state.params),
               stats=collect_host_arrays(state.batch_stats) if state.batch_stats else None,
               losses=[])
    for step in range(STEPS):
        state, metrics = jsetup.train_step(state, shard_batch(_batch(3 + step, size), mesh))
        run["losses"].append(float(metrics["train_loss"]))
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    held = _batch(97, size)
    embeddings = jax.jit(lambda v, x, t: jsetup.model.apply(v, x, t, train=False))(
        variables, held["images"], held["tokens"])
    run["embeddings"] = [np.asarray(e) for e in embeddings]
    return run


@pytest.fixture(scope="module")
def jax_runs():
    """Every twin's JAX lockstep, the three on threads: XLA compiles their
    steps side by side."""
    from concurrent.futures import ThreadPoolExecutor

    with _numpy_flax_init(seed=5), ThreadPoolExecutor(len(LOCKSTEPS)) as pool:
        futures = {name: pool.submit(_jax_run, name) for name in LOCKSTEPS}
        return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("name", sorted(LOCKSTEPS))
def test_lockstep_against_the_jax_step(jax_runs, name):
    knobs, loss_rtol = LOCKSTEPS[name]
    want = jax_runs[name]
    size = port_clip.MODEL_REGISTRY[name].image_size
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(
        dict(EXP6, model=name, **knobs)), steps_per_epoch=SPE, device="cpu")
    checkpoints.load_jax_params(setup.model, want["params"], want["stats"])
    state = setup.state
    for step in range(STEPS):
        state, metrics = setup.train_step(state, _batch(3 + step, size))
        assert float(metrics["train_loss"]) == pytest.approx(want["losses"][step],
                                                             rel=loss_rtol), step
    held = _batch(97, size)
    with torch.no_grad():
        got = state.model.eval()(torch.from_numpy(held["images"]),
                                 torch.from_numpy(held["tokens"]))
    for tower, g, w in zip(("img", "txt"), got, want["embeddings"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=EMBED_RTOL, atol=EMBED_ATOL,
                                   err_msg=tower)


def test_bf16_mu_over_slices_equals_the_whole_list_update(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    shapes = [(7, 5), (3,), (64,), (2, 2, 2), (1,), (33, 3)]
    runs = []
    for slice_values in (optim.SLICE_VALUES, 40, 1):
        monkeypatch.setattr(optim, "SLICE_VALUES", slice_values)
        params = [torch.randn(s, generator=torch.Generator().manual_seed(i)).requires_grad_()
                  for i, s in enumerate(shapes)]
        opt = optim.AdamWBf16Mu(params, lr=1e-2)
        gen.manual_seed(1)
        for _ in range(3):
            for p in params:
                p.grad = torch.randn(p.shape, generator=gen)
            opt.step()
        runs.append([(p.detach(), opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])
                     for p in params])
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
