"""The port's multi-process plumbing (``parallel/multihost.py``,
``parallel/mesh.py``, the loaders' per-process slices, the refusals) and
its CLI over 2 gloo ranks, against the JAX package and the one-rank CLI,
on the CPU.

* ``local_batch_indices`` and ``epoch_order``, host copies, equal the JAX
  functions (exact), and raise the JAX message.
* The loaders' per-process slices reassemble the single-process batch to
  the bit (images, tokens, captions) at 2 and 3 processes, and refuse an
  indivisible batch, an index out of range and ``drop_last`` off with the
  JAX loader's messages.
* The refusals by name: ``create_mesh`` off the world size, ``model > 1``,
  ``shard_opt_state``/``fsdp``/``pipeline``/``mesh_model`` over several
  ranks ('Multi-GPU'), ``soft_targets_provider`` over several ranks, a
  GradCache microbatch the ranks do not divide (the JAX message), grain
  over several processes, an unknown backend, ``multihost`` without its
  rendezvous keys.
* The CLI (``cli.main``) at 2 ranks, fresh processes started as
  ``torchrun`` would (``tests/torch_dp_worker.py``), against the same run
  at one rank: one JSONL (the primary's) whose per-step losses equal the
  one-rank run's to rtol 1e-5 (rings against the kernels' plain versions,
  fp32), evals up to one 4-decimal rounding step, one weights file,
  ``run_start`` naming world 2, gloo and the ring route; and a SIGTERM to
  rank 1 alone stops both ranks after the same step, with one full-state
  checkpoint.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from sparsify_clip_tpu.data import loader as jax_loader
from sparsify_clip_tpu.data.synthetic import SyntheticCaptions as JaxSyntheticCaptions
from sparsify_clip_tpu.parallel import multihost as jax_multihost
from sparsify_clip_tpu_torch import cli
from sparsify_clip_tpu_torch.config import ExperimentConfig, load_config
from sparsify_clip_tpu_torch.data import loader as port_loader
from sparsify_clip_tpu_torch.data import pipeline
from sparsify_clip_tpu_torch.data.synthetic import SyntheticCaptions
from sparsify_clip_tpu_torch.parallel import mesh as port_mesh
from sparsify_clip_tpu_torch.parallel import multihost
from sparsify_clip_tpu_torch.text import get_tokenizer
from sparsify_clip_tpu_torch.train import batch_to_device, check_supported

import test_torch_port_train as train_tests
import torch_dp_worker

# ----------------------------------------------------------- host copies


@pytest.mark.parametrize("n,seed,epoch,shuffle", [(37, 0, 0, True), (64, 3, 5, True),
                                                  (10, 1, 2, False)])
def test_epoch_order_equals_the_jax_function(n, seed, epoch, shuffle):
    np.testing.assert_array_equal(multihost.epoch_order(n, seed, epoch, shuffle),
                                  jax_multihost.epoch_order(n, seed, epoch, shuffle))


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_local_batch_indices_equal_the_jax_function(count):
    order = jax_multihost.epoch_order(48, 7, 1, True)
    for batch in range(4):
        for p in range(count):
            np.testing.assert_array_equal(
                multihost.local_batch_indices(order, batch, 12, p, count),
                jax_multihost.local_batch_indices(order, batch, 12, p, count))
    with pytest.raises(ValueError) as port_err:
        multihost.local_batch_indices(order, 0, 10, 0, 3)
    with pytest.raises(ValueError) as jax_err:
        jax_multihost.local_batch_indices(order, 0, 10, 0, 3)
    assert str(port_err.value) == str(jax_err.value)


def test_world_one_helpers_without_a_process_group():
    assert multihost.initialize_distributed(ExperimentConfig()) is None
    assert multihost.is_primary() and multihost.world_size() == 1
    x = torch.arange(6.0).view(3, 2)
    np.testing.assert_array_equal(multihost.allgather_to_host(x), x.numpy())
    assert multihost.any_process_flag(True) and not multihost.any_process_flag(False)
    mesh = port_mesh.create_mesh()
    assert (mesh.data, mesh.rank, mesh.backend) == (1, 0, None)
    assert mesh.batch_slice(8) == slice(0, 8)
    batch = {"images": np.ones((2, 4, 4, 3), np.float64), "tokens": np.ones((2, 77), np.int32),
             "captions": ["a", "b"]}
    got = batch_to_device(batch, torch.device("cpu"))
    assert sorted(got) == ["images", "tokens"] and got["images"].dtype == torch.float32
    staged = batch_to_device(dict(batch, images=np.ones((2, 4, 4, 3), np.uint8)),
                             torch.device("cpu"))
    assert staged["images"].dtype == torch.uint8  # device_augment's staging stays uint8


# -------------------------------------------------------------- loaders


def _loaders(make, count, **kwargs):
    ds = (SyntheticCaptions if make is port_loader.DataLoader else JaxSyntheticCaptions)(
        24, seed=3, image_size=16)
    tok = get_tokenizer("tiny-test")
    return [make(ds, 12, tok, train=True, seed=5, image_size=16, num_threads=1,
                 process_index=p, process_count=count, **kwargs) for p in range(count)]


@pytest.mark.parametrize("count", [2, 3])
def test_loader_slices_reassemble_the_global_batch(count):
    whole = list(_loaders(port_loader.DataLoader, 1)[0].epoch(1))
    parts = [list(loader.epoch(1)) for loader in _loaders(port_loader.DataLoader, count)]
    assert len(whole) == 2 and all(len(p) == 2 for p in parts)
    for b, batch in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b]["images"] for p in parts]),
                                      batch["images"])
        np.testing.assert_array_equal(np.concatenate([p[b]["tokens"] for p in parts]),
                                      batch["tokens"])
        assert sum((p[b]["captions"] for p in parts), []) == batch["captions"]
    # and each slice equals the JAX loader's slice
    jax_parts = [list(loader.epoch(1)) for loader in _loaders(jax_loader.DataLoader, count)]
    for p, q in zip(parts, jax_parts):
        for a, b in zip(p, q):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert a["captions"] == b["captions"]


@pytest.mark.parametrize("kwargs", [dict(process_index=0, process_count=5),
                                    dict(process_index=2, process_count=2),
                                    dict(process_index=0, process_count=2, drop_last=False)],
                         ids=["indivisible", "out-of-range", "drop-last-off"])
def test_loader_refusals_carry_the_jax_messages(kwargs):
    ds = SyntheticCaptions(24, seed=3, image_size=16)
    tok = get_tokenizer("tiny-test")
    errors = []
    for make in (port_loader.DataLoader, jax_loader.DataLoader):
        with pytest.raises(ValueError) as err:
            make(ds, 12, tok, train=True, image_size=16, num_threads=1, **kwargs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_grain_over_several_processes_is_refused(monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    config = ExperimentConfig.from_dict(dict(dataset="synthetic", loader_backend="grain"))
    with pytest.raises(ValueError, match="grain over 2 processes"):
        pipeline.dataset_loader(config)


# -------------------------------------------------------------- refusals


def test_create_mesh_refuses_a_data_axis_off_the_world_and_a_model_axis():
    with pytest.raises(ValueError, match="mesh data=4 × model=1 does not match .* world size 1"):
        port_mesh.create_mesh(data=4)
    with pytest.raises(ValueError, match="mesh_model=2 does not divide the world size 1"):
        port_mesh.create_mesh(model=2)
    with pytest.raises(ValueError, match="mesh data=1 × model=2 does not match"):
        port_mesh.create_mesh(data=1, model=2)


@pytest.mark.parametrize("knob", [dict(shard_opt_state=True), dict(fsdp=True),
                                  dict(pipeline=True), dict(mesh_model=2)],
                         ids=["shard_opt_state", "fsdp", "pipeline", "mesh_model"])
def test_multi_gpu_knobs_over_several_ranks_raise_by_name(knob):
    """ZeRO-1, FSDP, the model axis and GPipe run over several ranks
    (tests/test_torch_port_{zero1,fsdp,tp,pipeline}.py); GPipe, over a
    model axis of 2 stages, with ``scan_layers: true`` alone, and without
    it the JAX ValueError names it (train.py:477-481)."""
    config = ExperimentConfig.from_dict(dict(train_tests.BASE, **knob))
    name = next(iter(knob))
    if name != "pipeline":
        check_supported(config, world=2)
        check_supported(config, world=1)
        return
    check_supported(dataclasses.replace(config, scan_layers=True), world=2, model=2)
    with pytest.raises(ValueError, match=r"^pipeline: true requires scan_layers: true \(the "
                                         r"stacked \(layers, \.\.\.\) param layout is the "
                                         r"stage split\)$"):
        check_supported(config, world=2, model=2)


def test_soft_targets_provider_over_several_ranks_raises():
    config = ExperimentConfig.from_dict(dict(train_tests.BASE, loss_type="anchor-roberta",
                                             soft_targets_provider="mod:fn"))
    check_supported(config, world=1)
    with pytest.raises(NotImplementedError, match="soft_targets_provider.*single host"):
        check_supported(config, world=2)


def test_gradcache_microbatch_the_ranks_do_not_divide():
    """The JAX message (train.py:141-156); allow_accum_gather takes the
    gathered layout (tests/test_torch_port_zero1.py runs it)."""
    config = ExperimentConfig.from_dict(dict(train_tests.BASE, batch_size=12,
                                             grad_accum_steps=2))
    check_supported(config, world=2)
    with pytest.raises(ValueError, match=r"microbatch 6, not divisible by the data-mesh size 4"):
        check_supported(config, world=4)
    config = ExperimentConfig.from_dict(dict(train_tests.BASE, batch_size=12,
                                             grad_accum_steps=2, allow_accum_gather=True))
    check_supported(config, world=4)


def test_initialize_distributed_refusals():
    with pytest.raises(ValueError, match="backend 'mpi' is not one of"):
        multihost.initialize_distributed(None, backend="mpi")
    config = ExperimentConfig.from_dict(dict(multihost=True, num_processes=2))
    with pytest.raises(ValueError, match="needs coordinator_address, process_id"):
        multihost.initialize_distributed(config)


# -------------------------------------------------------- the CLI, 2 ranks

CLI = dict(project_name="t", run_name="dp-cli", seed=0, learning_rate=1e-3, batch_size=8,
           model="tiny-test", num_train_samples=16, num_test_samples=8, epochs=2,
           loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
           anchor_temperature=0.1, save_checkpoint_every_n_epochs=1, fp16=False,
           dataset="synthetic", log_backend="jsonl", plot_embeddings=False)
CLI_LOSS_RTOL = 1e-5
STOP = dict(CLI, run_name="dp-stop", num_train_samples=8 * 64, epochs=1, only_lunif_epochs=0,
            loss_type="anchor")


def _yaml(directory, fields):
    os.makedirs(directory, exist_ok=True)
    fields = dict(fields, log_dir=os.path.join(directory, "logs"),
                  checkpoint_dir=os.path.join(directory, "models"))
    path = os.path.join(directory, "run.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(fields, fh)
    return path


def _jsonl(path):
    import json

    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    two = os.path.join(root, "two")
    torch_dp_worker.spawn("cli", dict(yaml=_yaml(two, CLI)), two, 2)
    one = os.path.join(root, "one")
    cli.main(load_config(_yaml(one, CLI)), device="cpu")
    stop = os.path.join(root, "stop")
    log = os.path.join(stop, "logs", "dp-stop.jsonl")

    def first_step_logged():
        return os.path.exists(log) and any("train_loss" in r for r in _jsonl(log))

    stopped = torch_dp_worker.spawn("cli", dict(yaml=_yaml(stop, STOP)), stop, 2,
                                    signal_rank=1, signal_when=first_step_logged)
    return dict(two=two, one=one, stop=stop, stopped=stopped)


def test_cli_two_ranks_log_the_one_rank_run(cli_runs):
    assert os.listdir(os.path.join(cli_runs["two"], "logs")) == ["dp-cli.jsonl"]
    two = _jsonl(os.path.join(cli_runs["two"], "logs", "dp-cli.jsonl"))
    one = _jsonl(os.path.join(cli_runs["one"], "logs", "dp-cli.jsonl"))
    assert two[0]["parallel"] == {"world_size": 2, "backend": "gloo", "loss_route": "ring"}
    assert one[0]["parallel"] == {"world_size": 1, "backend": None, "loss_route": "kernel"}
    steps = [[r for r in log if "train_loss" in r] for log in (two, one)]
    assert len(steps[0]) == len(steps[1]) == 4  # 2 epochs of 2 steps: warm, then main
    for got, want in zip(*steps):
        for key in ("train_loss", "learning_rate"):
            assert got[key] == pytest.approx(want[key], rel=CLI_LOSS_RTOL), key
    evals = [[r for r in log if "forward_r1" in r] for log in (two, one)]
    assert len(evals[0]) == len(evals[1]) == 4  # before, after each epoch, final
    for got, want in zip(*evals):
        for key, value in want.items():
            if not key.startswith("_"):
                assert got[key] == pytest.approx(value, abs=1e-4 + 1e-12), key


def test_cli_two_ranks_write_one_weights_file(cli_runs):
    files = sorted(os.listdir(os.path.join(cli_runs["two"], "models")))
    assert files == ["dp-cli", "dp-cli.npz", "dp-cli_epoch_1.npz", "dp-cli_epoch_2.npz"]
    assert sorted(os.listdir(os.path.join(cli_runs["two"], "models", "dp-cli"))) == [
        "step_2.pt", "step_4.pt"]
    with np.load(os.path.join(cli_runs["two"], "models", "dp-cli.npz")) as f:
        two = {k: f[k] for k in f.files}
    from sparsify_clip_tpu_torch.checkpoints import load_weights
    from sparsify_clip_tpu_torch.models.clip import create_model

    one = create_model("tiny-test", device="cpu")
    load_weights(one, os.path.join(cli_runs["one"], "models", "dp-cli.npz"))
    train_tests._two_tier(dict(one.named_parameters()), two, tight_frac=0.999,
                          cap=2 * 1e-3 * 4)


def test_sigterm_to_one_rank_stops_both_after_the_same_step(cli_runs):
    outputs = [r["output"] for r in cli_runs["stopped"]]
    stops = [[line for line in out.splitlines() if line.startswith("[preemption] stopped")]
             for out in outputs]
    assert all(len(s) == 1 for s in stops), outputs
    assert stops[0] == stops[1]
    log = _jsonl(os.path.join(cli_runs["stop"], "logs", "dp-stop.jsonl"))
    trained = len([r for r in log if "train_loss" in r])
    assert any(r.get("preempted") for r in log) and 1 <= trained < 64
    assert stops[0][0].startswith(f"[preemption] stopped at step {trained} ")
    assert os.listdir(os.path.join(cli_runs["stop"], "models", "dp-stop")) == [
        f"step_{trained}.pt"]
