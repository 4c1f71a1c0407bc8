"""GPipe pipeline parallelism (``pipeline: true``) in the port, the
counterpart of tests/test_pipeline.py, on gloo ranks
(tests/torch_dp_worker.py's ``layouts`` job, in the launches that
tests/test_torch_port_tp.py shares: ``torch_layouts.model_axis_layouts``)
against the JAX package on the same numpy weights.

* **The trunk**: the pipelined ``Transformer`` alone at S = 2 and 4 stages
  (world 2 and 4), ``n_micro`` at its default and oversplit to 8, against
  the JAX pipelined ``Transformer`` on a ``model = S`` mesh of the
  conftest's CPU devices (tests/test_pipeline.py:34-81): values rtol 5e-4,
  atol 1e-5; the blocks' and the input's gradients of sum(y²) rtol 5e-4,
  atol 1e-4 (the JAX test's tolerances).
* **The train step**: ``pp-tiny`` (four blocks a tower) in the
  ``scan_layers`` layout, pp 2 at world 2 and dp 2 × pp 2 with ZeRO-1 at
  world 4, the exp-6 lockstep across the warm→main boundary against the
  JAX step (losses rel 1e-4, held-out embeddings rtol 2e-3, atol 5e-5);
  each rank holds its stage's blocks and nothing of the others'; a resume
  from the step-2 full state repeats step 3 bit for bit; the weights file
  holds the JAX scan-layout keys at full shape.
* **The eval**: the pipelined eval twin's 13 metrics against the
  one-process twin's, abs 2e-3 (tests/test_pipeline.py:241-276).

Without a launch: the scan-layout weights both ways (a JAX ``layers_scan``
file into the port, the port's ``scan_layers`` file into the JAX
``load_weights``), a stage's rank loading its stage alone, the seed's
weights equal on every layout, and every JAX refusal with its message.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import checkpoints as jax_checkpoints
from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.models.layers import Transformer as JaxTransformer
from sparsify_clip_tpu.parallel import pipeline as jax_pipeline
from sparsify_clip_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup

from sparsify_clip_tpu_torch import checkpoints
from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.models.layers import Transformer
from sparsify_clip_tpu_torch.parallel import pipeline
from sparsify_clip_tpu_torch.parallel.mesh import Mesh
from sparsify_clip_tpu_torch.parallel.sharding import shard_model
from sparsify_clip_tpu_torch.train import create_train_setup

import torch_layouts as tl

STEPS = {name: (world, spec) for world, cases in tl.PP_CASES.items()
         for name, spec in cases.items() if "trunk" not in spec}
TRUNKS = {name: (world, spec["trunk"]) for world, cases in tl.PP_CASES.items()
          for name, spec in cases.items() if "trunk" in spec}
VALUE_TOL = dict(rtol=5e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
EVAL_ATOL = 2e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tl.model_axis_layouts(tmp_path_factory)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(_flatten(v, path + "/") if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def jax_trunks():
    """The JAX pipelined trunk of every trunk case: y, and the gradients of
    sum(y²) with respect to the blocks (flat, scan layout) and to x."""
    flat = tl.trunk_weights()
    x = jnp.asarray(flat.pop("x"))
    variables = {"params": _nest(flat)}
    out = {}
    for name, (_, spec) in TRUNKS.items():
        stages = spec["stages"]
        mesh = jax_create_mesh(data=1, model=stages, devices=jax.devices()[:stages])
        model = JaxTransformer(width=spec["width"], layers=spec["layers"], heads=spec["heads"],
                               scan_layers=True, pipeline_stages=stages,
                               pipeline_microbatches=spec["n_micro"], pipeline_mesh=mesh)

        def fwd_bwd(v, x, model=model):
            y, vjp = jax.vjp(model.apply, v, x)
            return y, vjp(2 * y)

        y, (g_vars, g_x) = jax.jit(fwd_bwd)(variables, x)
        out[name] = dict(y=np.asarray(y), dx=np.asarray(g_x),
                         grads=_flatten(g_vars["params"]))
    return out


# ---------------------------------------------------------------- the trunk


@pytest.mark.parametrize("case", sorted(TRUNKS))
def test_pipelined_trunk_matches_the_jax_trunk(runs, jax_trunks, case):
    world, spec = TRUNKS[case]
    run = runs["worlds"][world]
    assert run["results"][0][case]["mesh"] == [world // spec["stages"], spec["stages"]]
    want = jax_trunks[case]
    np.testing.assert_allclose(run["arrays"][f"{case}/y"], want["y"], **VALUE_TOL)
    np.testing.assert_allclose(run["arrays"][f"{case}/dx"], want["dx"], **GRAD_TOL)
    got = {}
    for arrays in run["rank_arrays"]:
        prefix = f"{case}/grad/"
        got.update({k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)})
    want_grads = checkpoints.unstack_scan_layers(want["grads"])
    assert len(got) == len(want_grads)
    for path, g in want_grads.items():
        name, fn = checkpoints.torch_name(path)
        np.testing.assert_allclose(got[name], fn(g), err_msg=path, **GRAD_TOL)
    # each rank took the gradients of its stage's blocks alone
    per = spec["layers"] // spec["stages"]
    for rank, result in enumerate(run["results"]):
        blocks = {int(n.split(".")[1]) for n in result[case]["names"]}
        stage = rank % spec["stages"]
        assert blocks == set(range(stage * per, (stage + 1) * per)), (case, rank)


# ----------------------------------------------------------- the train step


@pytest.mark.parametrize("case", sorted(STEPS))
def test_pipeline_matches_the_jax_step(runs, case):
    world, _ = STEPS[case]
    run = runs["worlds"][world]
    assert run["results"][0][case]["mesh"] == [world // 2, 2]
    tl.assert_matches_jax(run, case, runs["refs"]["pp-tiny"])


@pytest.mark.parametrize("case", sorted(STEPS))
def test_pipeline_resume_repeats_step_3_bit_for_bit(runs, case):
    tl.assert_resumes_bit_for_bit(runs["worlds"][STEPS[case][0]], case, 2)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_pipeline_weights_file_holds_the_jax_scan_keys_at_full_shape(runs, case):
    path = runs["worlds"][STEPS[case][0]]["results"][0][case]["npz"]
    ref = runs["refs"]["pp-tiny"]
    assert any("/layers_scan/block/" in k for k in ref["final"])
    tl.assert_weights_file(path, ref)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_each_rank_holds_its_stages_share(runs, case):
    """The rank's parameters are the replicated ones and its stage's blocks
    of both towers, at fp32: bytes and names against one process's model."""
    world, spec = STEPS[case]
    one = dict(port_clip.create_model("pp-tiny", device="cpu").named_parameters())
    stages = spec["mesh_model"]
    per = {"visual": 4 // stages, "text": 4 // stages}
    for rank, result in enumerate(runs["worlds"][world]["results"]):
        stage = rank % stages
        want = sorted(n for n in one if ".resblocks." not in n
                      or int(n.split(".resblocks.")[1].split(".")[0]) // per[n.split(".")[0]]
                      == stage)
        rec = result[case]
        assert rec["names"] == want, (case, rank)
        assert rec["bytes"]["params"] == sum(one[n].numel() * 4 for n in want), (case, rank)
        assert rec["bytes"]["params"] < 0.75 * sum(p.numel() * 4 for p in one.values())


@pytest.mark.parametrize("case", sorted(STEPS))
def test_pipelined_eval_matches_the_one_process_eval(runs, case):
    for result in runs["worlds"][STEPS[case][0]]["results"]:
        got, want = result[case]["eval"]["twin"], result[case]["eval"]["one_process"]
        assert set(got) == set(want) and len(want) == 13
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=EVAL_ATOL), (case, key)


# ------------------------------------------------------ scan-layout weights


@pytest.fixture(scope="module")
def jax_scan_file(tmp_path_factory):
    """A JAX ``scan_layers`` CLIP's parameters, saved by the JAX ``save_weights``."""
    model = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY["pp-tiny"], scan_layers=True)
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 12), jnp.int32),
        train=False))()
    path = str(tmp_path_factory.mktemp("scan") / "jax.npz")
    jax_checkpoints.save_weights(variables["params"], path)
    return variables["params"], path


@pytest.mark.parametrize("scan_layers", [True, False])
def test_a_jax_scan_layout_file_loads_into_the_port(jax_scan_file, tmp_path, scan_layers):
    """The JAX ``layers_scan`` stacks unstack into ``resblocks.N``; a port
    model built with ``scan_layers`` writes them back stacked, equal to the
    JAX file bit for bit, and one without writes the unrolled keys."""
    _, path = jax_scan_file
    model = port_clip.create_model("pp-tiny", device="cpu", scan_layers=scan_layers)
    checkpoints.load_weights(model, path)
    with np.load(path) as f:
        want = {k: f[k] for k in f.files}
    got = checkpoints.collect_host_arrays(model)
    if not scan_layers:
        want = checkpoints.unstack_scan_layers(want)
        assert not any("layers_scan" in k for k in got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_ports_scan_layout_file_loads_into_jax(jax_scan_file, tmp_path):
    """The port's ``save_weights`` under ``scan_layers`` is read by the JAX
    ``load_weights`` into a JAX scan-layout tree: the same arrays."""
    params, path = jax_scan_file
    model = port_clip.create_model("pp-tiny", device="cpu", scan_layers=True)
    checkpoints.load_weights(model, path)
    out = checkpoints.save_weights(model, str(tmp_path / "port.npz"))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    restored = jax_checkpoints.load_weights(zeros, out)
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                         jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))


@pytest.mark.parametrize("stage", [0, 1])
def test_a_stages_rank_loads_its_stage_alone(jax_scan_file, stage):
    """Under the stage rule ``load_jax_params`` checks the whole file and
    fills the rank's stage's blocks and the replicated parameters (no
    collective: the layout is built without a process group)."""
    _, path = jax_scan_file
    mesh = Mesh(data=1, model=2, model_rank=stage)
    model = port_clip.create_model("pp-tiny", device="cpu", scan_layers=True,
                                   pipeline_stages=2, mesh=mesh)
    layout = shard_model(model, mesh, pipeline=True)
    assert len(layout.placements) == len(layout.full_names) > len(dict(model.named_parameters()))
    checkpoints.load_weights(model, path)
    with np.load(path) as f:
        flat = checkpoints.unstack_scan_layers({k: f[k] for k in f.files})
    own = dict(model.named_parameters())
    blocks = set()
    for jax_path, arr in flat.items():
        name, fn = checkpoints.torch_name(jax_path)
        if name in own:
            np.testing.assert_array_equal(own[name].detach().numpy(), fn(arr), err_msg=name)
            if ".resblocks." in name:
                blocks.add(int(name.split(".resblocks.")[1].split(".")[0]))
        else:
            assert layout.stages[name][0] == 1 - stage, name
    assert blocks == {2 * stage, 2 * stage + 1}


@pytest.mark.parametrize("stages", [2, 4])
def test_the_seed_gives_the_same_weights_on_every_stage(stages):
    """mesh/pipeline must not affect parameter values (tests/test_pipeline.py:
    94-99): each stage's blocks and replicated parameters are the
    one-process model's of the same names."""
    one = dict(port_clip.create_model("pp-tiny", device="cpu").named_parameters())
    for rank in range(stages):
        mesh = Mesh(data=1, model=stages, model_rank=rank)
        model = port_clip.create_model("pp-tiny", device="cpu", scan_layers=True,
                                       pipeline_stages=stages, mesh=mesh)
        named = dict(model.named_parameters())
        assert len(named) < len(one)
        for n, p in named.items():
            assert torch.equal(p, one[n]), (rank, n)


def test_stacked_layers_and_the_bubble_share():
    mesh = Mesh(data=1, model=2, model_rank=1)
    trunk = Transformer(16, 4, 2, scan_layers=True, pipeline_stages=2, mesh=mesh)
    assert pipeline.stacked_layers(trunk) == 4 == jax_pipeline.stacked_layers(
        {"k": np.zeros((4, 3))})
    assert list(trunk.resblocks) == ["2", "3"]
    assert pipeline.bubble_share(2, 2) == pytest.approx(1 / 3)
    assert pipeline.bubble_share(4, 8) == pytest.approx(3 / 11)


# ---------------------------------------------------------------- refusals

jax_clip.MODEL_REGISTRY.setdefault("pp-tiny-odd", dataclasses.replace(
    jax_clip.MODEL_REGISTRY["pp-tiny"], name="pp-tiny-odd", vision_layers=(3,)))
port_clip.MODEL_REGISTRY.setdefault("pp-tiny-odd", dataclasses.replace(
    port_clip.MODEL_REGISTRY["pp-tiny"], name="pp-tiny-odd", vision_layers=(3,)))

PP_ON = dict(pipeline=True, scan_layers=True)
REFUSALS = {  # tests/test_pipeline.py:150-227, and a model axis of one rank
    "mesh_model": ((8, 1), PP_ON),
    "scan_layers": ((2, 4), dict(pipeline=True)),
    "resnet": ((2, 4), dict(PP_ON, model="RN50")),
    "depth": ((2, 4), dict(PP_ON, model="pp-tiny-odd")),
    "fsdp": ((2, 4), dict(PP_ON, fsdp=True)),
    "grad_accum": ((2, 4), dict(PP_ON, grad_accum_steps=2)),
    "remat": ((2, 4), dict(PP_ON, remat=True)),
}


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_the_train_setup_refuses_with_the_jax_message(refusal):
    (dp, mm), fields = REFUSALS[refusal]
    fields = dict(dict(model="pp-tiny", batch_size=16, epochs=1, learning_rate=1e-3,
                       mesh_data=dp, mesh_model=mm), **fields)
    with pytest.raises(ValueError) as jax_err:
        jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields), steps_per_epoch=4,
                               mesh=jax_create_mesh(data=dp, model=mm))
    with pytest.raises(ValueError) as port_err:
        create_train_setup(ExperimentConfig.from_dict(fields), steps_per_epoch=4, device="cpu",
                           mesh=Mesh(data=dp, model=mm))
    assert str(port_err.value) == str(jax_err.value)


def _jax_message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


MODULE_REFUSALS = {
    # models/clip.py:183-187
    "clip_resnet": (
        lambda: jax.eval_shape(lambda: jax_clip.CLIP(
            cfg=jax_clip.MODEL_REGISTRY["RN50"], pipeline_stages=2).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32),
            train=False)),
        lambda: port_clip.CLIP(port_clip.MODEL_REGISTRY["RN50"], pipeline_stages=2,
                               mesh=Mesh(model=2))),
    # models/layers.py:347-353
    "trunk_scan_layers": (
        lambda: JaxTransformer(width=16, layers=4, heads=2, pipeline_stages=2,
                               pipeline_mesh=jax_create_mesh(data=4, model=2)).apply(
            JaxTransformer(width=16, layers=4, heads=2).init(
                jax.random.PRNGKey(0), jnp.zeros((2, 5, 16))), jnp.zeros((2, 5, 16))),
        lambda: Transformer(16, 4, 2, pipeline_stages=2, mesh=Mesh(model=2))),
    "trunk_mesh": (
        lambda: JaxTransformer(width=16, layers=4, heads=2, scan_layers=True,
                               pipeline_stages=2).apply(
            JaxTransformer(width=16, layers=4, heads=2, scan_layers=True).init(
                jax.random.PRNGKey(0), jnp.zeros((2, 5, 16))), jnp.zeros((2, 5, 16))),
        lambda: Transformer(16, 4, 2, scan_layers=True, pipeline_stages=2)),
    # parallel/pipeline.py:55-70
    "microbatches": (lambda: jax_pipeline.validate_pipeline(4, 4, 8, 0),
                     lambda: pipeline.validate_pipeline(4, 4, 8, 0)),
    "layers": (lambda: jax_pipeline.validate_pipeline(3, 2, 8, 2),
               lambda: pipeline.validate_pipeline(3, 2, 8, 2)),
    "local_batch": (lambda: jax_pipeline.validate_pipeline(4, 2, 6, 4),
                    lambda: pipeline.validate_pipeline(4, 2, 6, 4)),
}


@pytest.mark.parametrize("refusal", sorted(MODULE_REFUSALS))
def test_the_modules_refuse_with_the_jax_message(refusal):
    jax_fn, port_fn = MODULE_REFUSALS[refusal]
    want = _jax_message(jax_fn)
    with torch.device("meta"), pytest.raises(ValueError) as err:
        port_fn()
    assert str(err.value) == want
