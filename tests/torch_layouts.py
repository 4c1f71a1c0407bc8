"""What tests/test_torch_port_{zero1,fsdp,tp,pipeline}.py share: the JAX
tests' models (tests/test_tp_equivalence.py's ``tp-tiny``, with non-4×
MLPs, and ``rn-tiny``; tests/test_pipeline.py's ``pp-tiny``, four blocks
a tower, in the ``scan_layers`` layout), their exp-6 lockstep across the
warm→main boundary, the JAX reference run of it, and the port's runs on
gloo ranks (``tests/torch_dp_worker.py``'s ``layouts`` job).

The model axis's layouts (tensor parallelism and the GPipe pipeline,
with the pipelined trunk alone) share one launch a world size,
:func:`model_axis_layouts`, which the first of their test files to ask
runs and the others read.

The JAX reference runs on one device: the JAX package's layouts are a
layout choice, not a numerics one (its tests pin dp against tp and
ZeRO-1 and FSDP against replicated), so one run serves every port layout.
The tolerances are the JAX test's own (test_tp_equivalence.py:86-110):
the per-step losses rel 1e-4, the final embeddings of a held-out batch
rtol 2e-3, atol 5e-5.
"""

import os

import numpy as np
import pytest

import jax

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup

import test_torch_port_rn50 as rn50_tests
import torch_dp_worker

B, STEPS, SPE = 16, 3, 2  # steps 0 and 1 warm, step 2 main
LOSS_RTOL = 1e-4
EMBED_RTOL, EMBED_ATOL = 2e-3, 5e-5
EXP6 = dict(batch_size=B, epochs=2, learning_rate=1e-3, seed=0, fp16=False,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1)

jax_clip.MODEL_REGISTRY.setdefault("tp-tiny", jax_clip.CLIPConfig(
    name="tp-tiny", embed_dim=16, vision_kind="vit", image_size=32, vision_width=32,
    vision_layers=(2,), vision_heads=2, patch_size=16, vocab_size=256, context_length=12,
    text_width=16, text_heads=2, text_layers=2, vision_mlp_hidden=48, text_mlp_hidden=24))
jax_clip.MODEL_REGISTRY.setdefault("rn-tiny", jax_clip.CLIPConfig(
    name="rn-tiny", embed_dim=16, vision_kind="resnet", image_size=32, vision_width=8,
    vision_layers=(1, 1, 1, 1), vision_heads=4, vocab_size=256, context_length=12,
    text_width=16, text_heads=2, text_layers=2))
jax_clip.MODEL_REGISTRY.setdefault("pp-tiny", jax_clip.CLIPConfig(
    name="pp-tiny", embed_dim=16, vision_kind="vit", image_size=32, vision_width=32,
    vision_layers=(4,), vision_heads=2, patch_size=16, vocab_size=256, context_length=12,
    text_width=16, text_heads=2, text_layers=4))
torch_dp_worker.register_test_models()

# the model axis's cases, by world size: tensor parallelism
# (tests/test_torch_port_tp.py) and the pipeline
# (tests/test_torch_port_pipeline.py), in one launch a world
TP_CASES = {
    2: {
        "tp2": dict(model="tp-tiny", mesh_model=2, save_at=2, npz=True),
        "rn-tp2": dict(model="rn-tiny", mesh_model=2),
        "tp2-fused": dict(model="tp-tiny", mesh_model=2, fused_ln_qkv=True),
    },
    4: {
        "dp2tp2": dict(model="tp-tiny", mesh_model=2),
        "dp2tp2-zero1": dict(model="tp-tiny", mesh_model=2, shard_opt_state=True),
        "dp2tp2-fsdp": dict(model="tp-tiny", mesh_model=2, fsdp=True, save_at=2),
    },
}
PP = dict(model="pp-tiny", mesh_model=2, pipeline=True, scan_layers=True, save_at=2,
          eval=True)
# the pipelined trunk alone: tests/test_pipeline.py's (width 16, 4 blocks,
# 2 heads, 16 rows of 5 tokens) at S = 2 and 4 stages, n_micro at its
# default (S) and oversplit (8)
TRUNK = dict(width=16, layers=4, heads=2)
TRUNK_X = (16, 5, 16)
PP_CASES = {
    2: {"pp2": dict(PP, npz=True),
        **{f"trunk-s2-m{m}": dict(trunk=dict(TRUNK, stages=2, n_micro=m)) for m in (None, 8)}},
    4: {"dp2pp2-zero1": dict(PP, shard_opt_state=True, npz=True),
        **{f"trunk-s4-m{m}": dict(trunk=dict(TRUNK, stages=4, n_micro=m)) for m in (None, 8)}},
}
MODEL_AXIS_REFS = {"tp-tiny": ("tp-tiny", {}), "rn-tiny": ("rn-tiny", {}),
                   "pp-tiny": ("pp-tiny", {"scan_layers": True})}


def batches(seed: int):
    """The JAX test's batch (test_tp_equivalence.py:46-53) from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 250, size=(B, 12)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 254, 255
    return {"images": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "tokens": tokens}


SEEDS = [3 + s for s in range(STEPS)] + [97]  # the train batches, then the held-out one


def write_batches(directory: str) -> str:
    path = os.path.join(directory, "batches.npz")
    arrays = {}
    for i, seed in enumerate(SEEDS):
        batch = batches(seed)
        arrays[f"images{i}"], arrays[f"tokens{i}"] = batch["images"], batch["tokens"]
    np.savez(path, **arrays)
    return path


class JaxReferences:
    """The JAX runs, computed once for every test file of one pytest run:
    each is cached (under a lock) in a directory the xdist workers share.
    :meth:`initial` writes a model's JAX initial weights; :meth:`run`
    returns its lockstep."""

    def __init__(self, tmp_path_factory):
        base = tmp_path_factory.getbasetemp()
        shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
        self.directory = os.path.join(str(shared), "jax_layout_references")
        os.makedirs(self.directory, exist_ok=True)
        self.setups = {}

    def _cached(self, key: str, suffix: str, make):
        import fcntl
        import pickle

        path = os.path.join(self.directory, f"{key}.{suffix}")
        with open(os.path.join(self.directory, f"{key}.{suffix}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(path):
                value = make()
                with open(f"{path}.tmp", "wb") as fh:
                    pickle.dump(value, fh)
                os.replace(f"{path}.tmp", path)
        with open(path, "rb") as fh:
            return pickle.load(fh)

    def _setup(self, model: str, extra: dict):
        key = _key(model, extra)
        if key not in self.setups:
            mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
            fields = dict(EXP6, model=model, **extra)
            with rn50_tests._jitted_flax_init():
                setup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                               steps_per_epoch=SPE, mesh=mesh)
            self.setups[key] = (setup, mesh)
        return self.setups[key]

    def initial(self, model: str, **extra) -> str:
        """The path of the JAX initial weights (and statistics) as an npz."""
        def make():
            setup, _ = self._setup(model, extra)
            initial = collect_host_arrays(setup.state.params)
            stats = (collect_host_arrays(setup.state.batch_stats)
                     if setup.state.batch_stats else {})
            path = os.path.join(self.directory, f"{_key(model, extra)}_initial.npz")
            np.savez(path, **initial, **{f"batch_stats/{k}": v for k, v in stats.items()})
            return path

        return self._cached(_key(model, extra), "initial", make)

    def run(self, model: str, **extra) -> dict:
        """The JAX step on one device (its config's fields over EXP6 and
        ``extra``): per-step metrics, final embeddings of the held-out batch
        and params, and the initial weights' path."""
        import jax.numpy as jnp

        def make():
            setup, mesh = self._setup(model, extra)
            state, log = setup.state, []
            for seed in SEEDS[:STEPS]:
                state, metrics = setup.train_step(state, shard_batch(batches(seed), mesh))
                log.append({k: float(v) for k, v in metrics.items()})
            held = batches(SEEDS[-1])
            variables = {"params": state.params}
            if state.batch_stats:
                variables["batch_stats"] = state.batch_stats
            img, txt = setup.model.apply(variables, jnp.asarray(held["images"]),
                                         jnp.asarray(held["tokens"]), train=False)
            return dict(log=log, img=np.asarray(img), txt=np.asarray(txt),
                        final=collect_host_arrays(state.params))

        initial = self.initial(model, **extra)  # before the steps donate the state
        return dict(self._cached(_key(model, extra), "run", make), initial=initial)


def _key(model: str, extra: dict) -> str:
    return "-".join([model] + [f"{k}{v}" for k, v in sorted(extra.items())])


def layouts(tmp_path_factory, name: str, worlds: dict, refs: dict) -> dict:
    """The JAX runs of ``refs`` (key → (model, extra fields)) and the port's
    ``worlds`` (world size → cases, :func:`run_layouts`); the ranks start
    as soon as the JAX initial weights exist and train while JAX does."""
    import threading

    jax_refs = JaxReferences(tmp_path_factory)
    initial = {k: jax_refs.initial(m, **extra) for k, (m, extra) in refs.items()}
    ports, errors = {}, []

    def launch():
        try:
            for world, cases in worlds.items():
                directory = str(tmp_path_factory.mktemp(f"{name}{world}"))
                ports[world] = run_layouts(directory, world, cases, initial)
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    thread = threading.Thread(target=launch)
    thread.start()
    try:
        done = {k: jax_refs.run(m, **extra) for k, (m, extra) in refs.items()}
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return dict(refs=done, worlds=ports)


def trunk_weights(seed: int = 0) -> dict:
    """The JAX scan-layout parameters of the ``TRUNK`` Transformer
    (``layers_scan/block/...``, a leading layer axis) and its input ``x``,
    drawn with numpy from ``seed``."""
    from sparsify_clip_tpu_torch.checkpoints import jax_paths, stack_scan_layers
    from sparsify_clip_tpu_torch.models.layers import Transformer

    rng = np.random.default_rng(seed)
    trunk = Transformer(**TRUNK)
    flat = {}
    for name, (path, fn) in jax_paths(trunk).items():
        shape = fn(np.empty(tuple(trunk.get_parameter(name).shape))).shape
        if path.endswith("ln/scale"):
            arr = 1 + 0.1 * rng.standard_normal(shape)
        elif path.endswith("bias"):
            arr = 0.1 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0])
        flat[path] = arr.astype(np.float32)
    flat = stack_scan_layers(flat)
    flat["x"] = rng.standard_normal(TRUNK_X).astype(np.float32)
    return flat


def model_axis_layouts(tmp_path_factory) -> dict:
    """The launches of ``TP_CASES`` and ``PP_CASES`` together (one a world
    size) with the JAX runs of ``MODEL_AXIS_REFS``: run once a pytest run,
    by the first test file that asks, and read by the others."""
    cases = {w: {**TP_CASES[w], **PP_CASES[w]} for w in TP_CASES}
    return JaxReferences(tmp_path_factory)._cached(
        "model_axis", "layouts",
        lambda: layouts(tmp_path_factory, "model_axis", cases, MODEL_AXIS_REFS))


def run_layouts(directory: str, world: int, cases: dict, initial: dict) -> dict:
    """Spawn ``world`` gloo ranks running ``cases`` (name → config fields
    over EXP6, plus ``save_at``/``npz``/``eval``, and ``ref``: the key of
    its JAX initial weights in ``initial``, by default the model's; or a
    ``trunk``, which reads :func:`trunk_weights`).  Every rank's arrays
    come back under ``rank_arrays``, rank 0's under ``arrays``."""
    plan_cases = []
    weights = None
    for name, spec in cases.items():
        spec = dict(spec)
        if "trunk" in spec:
            if weights is None:
                weights = os.path.join(directory, "trunk_weights.npz")
                np.savez(weights, **trunk_weights())
            plan_cases.append(dict(name=name, trunk=spec["trunk"], weights=weights))
            continue
        extra = {k: spec.pop(k) for k in ("save_at", "npz", "eval") if k in spec}
        ref = spec.pop("ref", spec["model"])
        fields = dict(EXP6, **spec)
        plan_cases.append(dict(name=name, fields=fields, steps_per_epoch=SPE,
                               initial=initial[ref], **extra))
    plan = dict(cases=plan_cases, batches=write_batches(directory), dir=directory)
    results = torch_dp_worker.spawn("layouts", plan, directory, world)
    ranks = [torch_dp_worker.arrays(directory, "layouts", r) for r in range(world)]
    return dict(results=results, arrays=ranks[0], rank_arrays=ranks)


def assert_matches_jax(run: dict, name: str, ref: dict) -> None:
    """Every rank reports the same losses and holds the same full state;
    the losses and the held-out embeddings match the JAX run."""
    logs = [r[name]["log"] for r in run["results"]]
    assert all(log == logs[0] for log in logs), name
    assert len({r[name]["digest"] for r in run["results"]}) == 1, name
    for step, (got, want) in enumerate(zip(logs[0], ref["log"])):
        assert got["train_loss"] == pytest.approx(want["train_loss"], rel=LOSS_RTOL), step
        assert (got["anchor"] == 0.0) == (step < SPE), step
    for key in ("img", "txt"):
        np.testing.assert_allclose(run["arrays"][f"{name}/{key}"], ref[key],
                                   rtol=EMBED_RTOL, atol=EMBED_ATOL, err_msg=f"{name}/{key}")


def assert_resumes_bit_for_bit(run: dict, name: str, save_at: int) -> None:
    """The resume from the step-``save_at`` save repeats the later steps
    exactly: the same losses, the same full state."""
    for r in run["results"]:
        assert r[name]["resumed_log"] == r[name]["log"][save_at:], name
        assert r[name]["resumed_digest"] == r[name]["digest"], name


def assert_weights_file(path: str, ref: dict) -> None:
    """The npz holds the JAX keys at full shape."""
    with np.load(path) as f:
        got = {k: f[k].shape for k in f.files}
    assert got == {k: v.shape for k, v in ref["final"].items()}
