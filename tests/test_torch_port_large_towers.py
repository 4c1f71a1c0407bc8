"""The repository's two large-tower YAMLs and the registry's three largest
towers in the port, on the CPU, against the JAX package.

* **The YAMLs**: ``configs/vitg14_fsdp_pod.yaml`` and
  ``configs/vith14_pipeline.yaml`` parse to equal configs in both
  packages' ``load_config``, field by field (exact).
* **The registry**: ViT-H-14, ViT-g-14 and ViT-bigG-14 are equal field by
  field in both registries (exact).
* **The towers**: a narrow twin of each (``TWINS`` of
  tests/test_torch_port_large_towers_rank.py: the vision head_dim 80, 88
  or 104 and the MLP ratio,
  the text head_dim 64, at 2 heads and 2 blocks), at 224 px (257 tokens),
  with numpy weights carried into the port by ``load_jax_params``: its
  image and text embeddings against the JAX forward in fp32, rtol 2e-4,
  atol 2e-5 (tests/test_torch_port_models.py's tolerance).
* **The step knobs** of each YAML on its tower's twin, 3 steps against the
  JAX step on one device, through tests/test_torch_port_pipeline.py's
  harness (tests/torch_layouts.py, one launch of 2 gloo ranks whose rank
  script registers the twins): ViT-g-14's FSDP over 2 data ranks with the
  bf16 first moment and ``anchor`` at a fixed T, ViT-H-14's GPipe at S =
  2 over its 4 microbatches (fp32 compute, so the comparison sees the
  layout and not bf16 rounding).  Losses rel 1e-4, the held-out batch's
  embeddings rtol 2e-3, atol 5e-5 (the JAX layout tests' tolerances).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import fill_from_flat
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.models import clip as port_clip

import torch_dp_worker
import torch_layouts as tl
from test_torch_port_large_towers_rank import TWINS, register_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SCRIPT = os.path.join(REPO, "tests", "test_torch_port_large_towers_rank.py")
YAMLS = ("vitg14_fsdp_pod.yaml", "vith14_pipeline.yaml")
TOWERS = {"ViT-H-14": "h14-twin", "ViT-g-14": "g14-twin", "ViT-bigG-14": "bigG-twin"}
FP32 = dict(rtol=2e-4, atol=2e-5)
register_twins(jax_clip.MODEL_REGISTRY, jax_clip.CLIPConfig)
register_twins(port_clip.MODEL_REGISTRY, port_clip.CLIPConfig)

# the step knobs of both YAMLs (anchor at a fixed T of 0.1, their learning
# rate) on their towers' twins, at world 2, over the harness's EXP6 fields
YAML_STEP = dict(learning_rate=1e-4, loss_type="anchor", only_lunif_epochs=0,
                 anchor_temperature=0.1, anchor_temperature_learnable=False)
CASES = {
    "g14-fsdp": dict(YAML_STEP, model="g14-twin", fsdp=True, adam_mu_dtype="bfloat16"),
    "h14-pp2": dict(YAML_STEP, model="h14-twin", mesh_model=2, pipeline=True,
                    scan_layers=True, pipeline_microbatches=4),
}
REFS = {"g14-twin": ("g14-twin", dict(YAML_STEP, adam_mu_dtype="bfloat16")),
        "h14-twin": ("h14-twin", dict(YAML_STEP, scan_layers=True))}


@pytest.mark.parametrize("name", YAMLS)
def test_the_yaml_parses_to_equal_configs_in_both_packages(name):
    path = os.path.join(REPO, "configs", name)
    want = dataclasses.asdict(jax_config.load_config(path))
    got = dataclasses.asdict(port_config.load_config(path))
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_the_registry_entry_is_the_jax_entry(name):
    want = dataclasses.asdict(jax_clip.MODEL_REGISTRY[name])
    assert dataclasses.asdict(port_clip.MODEL_REGISTRY[name]) == want


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_the_twin_keeps_the_towers_head_dims_and_mlp_ratio(name):
    real, twin = port_clip.MODEL_REGISTRY[name], port_clip.MODEL_REGISTRY[TOWERS[name]]
    assert twin.vision_width // twin.vision_heads == real.vision_width // real.vision_heads
    assert twin.text_width // twin.text_heads == real.text_width // real.text_heads == 64
    ratio = lambda cfg: (cfg.vision_mlp_hidden or 4 * cfg.vision_width) / cfg.vision_width  # noqa: E731
    assert ratio(twin) == ratio(real)
    assert (twin.vision_heads, twin.vision_layers, twin.text_heads, twin.text_layers) == (
        2, (2,), 2, 2)
    assert jax_clip.MODEL_REGISTRY[TOWERS[name]] == jax_clip.CLIPConfig(**TWINS[TOWERS[name]])


def _token_rows(n: int, context: int, vocab: int, seed: int) -> np.ndarray:
    """SOT first, EOT at a random place, zero padding after it."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, vocab - 2, size=(n, context)).astype(np.int32)
    rows[:, 0] = vocab - 2
    for i, eot in enumerate(rng.integers(1, context, size=n)):
        rows[i, eot], rows[i, eot + 1:] = vocab - 1, 0
    return rows


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_the_twins_embeddings_equal_the_jax_forward(name):
    """fp32, rtol 2e-4, atol 2e-5, at the towers' 224 px in 14 px patches:
    257 vision tokens."""
    twin = TOWERS[name]
    cfg = dataclasses.replace(jax_clip.MODEL_REGISTRY[twin], image_size=224, patch_size=14)
    jmodel = jax_clip.CLIP(cfg=cfg, dtype=jnp.float32)
    rng = np.random.default_rng(23)
    images = rng.standard_normal((3, 224, 224, 3)).astype(np.float32)
    tokens = _token_rows(3, cfg.context_length, cfg.vocab_size, seed=29)
    # the parameter tree's shapes alone, filled with numpy draws
    shapes = jax.eval_shape(lambda x, t: jmodel.init(jax.random.PRNGKey(0), x, t),
                            images, tokens)["params"]
    flat = {"/".join(k.key for k in path): (
        1 + 0.1 * rng.standard_normal(leaf.shape) if path[-1].key == "scale"
        and path[-2].key == "ln" else 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))(
        fill_from_flat(shapes, flat), images, tokens)
    port = load_jax_params(port_clip.CLIP(dataclasses.replace(
        port_clip.MODEL_REGISTRY[twin], image_size=224, patch_size=14)), flat).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(tokens))
    for tower, g, w in zip(("image", "text"), got, want):
        assert g.shape == w.shape == (3, cfg.embed_dim), tower
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=tower, **FP32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The harness's launch and JAX runs, its ranks started from the rank
    script that registers the twins (``spawn`` starts the file it is
    told ``torch_dp_worker`` is)."""
    original = torch_dp_worker.__file__
    torch_dp_worker.__file__ = RANK_SCRIPT
    try:
        return tl.layouts(tmp_path_factory, "large", {2: CASES}, REFS)
    finally:
        torch_dp_worker.__file__ = original


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_yamls_step_knobs_match_the_jax_step(runs, case):
    """Losses rel 1e-4 at each of the 3 steps, the held-out embeddings
    rtol 2e-3, atol 5e-5; every rank the same losses and full state."""
    spec = CASES[case]
    run, ref = runs["worlds"][2], runs["refs"][spec["model"]]
    results = [r[case] for r in run["results"]]
    assert results[0]["mesh"] == ([1, 2] if spec.get("pipeline") else [2, 1])
    assert all(r["log"] == results[0]["log"] for r in results), case
    assert len({r["digest"] for r in results}) == 1, case
    assert len(results[0]["log"]) == len(ref["log"]) == tl.STEPS
    for step, (got, want) in enumerate(zip(results[0]["log"], ref["log"])):
        assert got["train_loss"] == pytest.approx(want["train_loss"], rel=tl.LOSS_RTOL), step
    for key in ("img", "txt"):
        np.testing.assert_allclose(run["arrays"][f"{case}/{key}"], ref[key],
                                   rtol=tl.EMBED_RTOL, atol=tl.EMBED_ATOL,
                                   err_msg=f"{case}/{key}")


def test_the_g14_knobs_keep_a_bf16_first_moment_on_each_shard(runs):
    """FSDP's shard of each moment: fp32 ν and bf16 μ, 6 bytes for every
    4-byte parameter value the rank holds, and half the twin's values."""
    full = sum(p.numel() for p in port_clip.create_model("g14-twin", device="cpu").parameters())
    for result in runs["worlds"][2]["results"]:
        held = result["g14-fsdp"]["bytes"]
        assert held["moments"] * 4 == held["params"] * 6
        assert held["params"] < 0.6 * 4 * full
