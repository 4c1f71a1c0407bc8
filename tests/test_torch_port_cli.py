"""The port's CLI, logging, preemption and resume on the CPU, against the
JAX package's: the JSONL records of ``RunLogger`` (all but ``_time``),
``GracefulShutdown`` under a real SIGTERM, a mid-epoch SIGTERM then
``resume_checkpoint: "auto"`` run bit-identical to the uninterrupted run,
the CLI on ``configs/smoke_tiny.yaml --smoke`` giving the JAX CLI's
record kinds and keys in the same order, the folder sweep, the refusals,
``debug_nans``, and the port importing none of jax, regex, PIL, orbax
and sparsify_clip_tpu.
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

from sparsify_clip_tpu import cli as jax_cli
from sparsify_clip_tpu import logging as jax_logging
from sparsify_clip_tpu_torch import cli, logging
from sparsify_clip_tpu_torch.config import ExperimentConfig, load_config
from sparsify_clip_tpu_torch.utils.preemption import GracefulShutdown

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SMOKE_TINY = os.path.join(REPO, "configs", "smoke_tiny.yaml")


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _shape(records):
    """Each record's keys, and a run_start's config keys."""
    return [(sorted(r), sorted(r["config"]) if r.get("event") == "run_start" else None)
            for r in records]


def test_run_logger_records_equal_the_jax_loggers(tmp_path):
    metrics = {"train_loss": 1.5, "temperature": 0.25, "learning_rate": 1e-4, "beta": 0.5,
               "alpha": 0.75, "anchor": 1.0, "lalign": 0.25, "lunif": -0.5, "siglip_bias": 2.0}
    runs = []
    for module, sub in ((jax_logging, "jax"), (logging, "port")):
        log = module.RunLogger("p", "run/a", config={"seed": 1}, log_dir=str(tmp_path / sub),
                               backend="auto")  # no wandb here: JSONL
        log.log_train_step(metrics, True)
        log.log_train_step(metrics, False, include_components=True)
        log.log({"forward_r1": 12.5, "event_count": np.float32(3.0)})
        log.log_image("plot", "x.png")
        log.save_artifact(str(tmp_path / "w.npz"))
        log.finish()
        runs.append([{k: v for k, v in r.items() if k != "_time"} for r in _records(log.path)])
        assert os.path.basename(log.path) == "run_a.jsonl"
    assert runs[1] == runs[0]
    assert "constrantive_temperature_learnable" in runs[1][1]
    null = logging.NullLogger()
    null.log({"a": 1})
    null.log_train_step(metrics, True)
    null.finish()


def test_graceful_shutdown_flags_sigterm_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as shutdown:
        assert shutdown.active and not shutdown.requested
        os.kill(os.getpid(), signal.SIGTERM)  # delivered synchronously
        assert shutdown.requested
        assert shutdown.requested_fn()
    assert signal.getsignal(signal.SIGTERM) is prev

    seen = {}

    def worker():
        with GracefulShutdown() as off_main:
            seen["active"], seen["requested"] = off_main.active, off_main.requested

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen == {"active": False, "requested": False}


def _resume_config(tmp_path, **fields):
    return ExperimentConfig.from_dict(dict(dict(
        project_name="t", run_name="resume", seed=3, learning_rate=1e-3, batch_size=8,
        model="tiny-test", num_train_samples=24, num_test_samples=8, epochs=2,
        loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
        anchor_temperature=0.1, fp16=False, save_checkpoint_every_n_epochs=1,
        dataset="synthetic", plot_embeddings=False, log_backend="jsonl",
        log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "models")), **fields))


def test_sigterm_then_auto_resume_is_bit_identical(tmp_path, monkeypatch):
    full = _resume_config(tmp_path / "full")
    cli.main(full, device="cpu")

    # the same run, sent SIGTERM after its second train record (step 2 of
    # epoch 0's 3), then resumed from <checkpoint_dir>/<run_name>/
    stopped = _resume_config(tmp_path / "stopped")
    calls = {"n": 0}
    log_train_step = logging.RunLogger.log_train_step

    def signalling(self, *args, **kwargs):
        log_train_step(self, *args, **kwargs)
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(logging.RunLogger, "log_train_step", signalling)
    cli.main(stopped, device="cpu")
    monkeypatch.undo()
    models = tmp_path / "stopped" / "models"
    assert sorted(os.listdir(models / "resume")) == ["step_2.pt"]
    assert not (models / "resume.npz").exists()
    cli.main(dataclasses.replace(stopped, resume_checkpoint="auto"), device="cpu")

    with np.load(tmp_path / "full" / "models" / "resume.npz") as a, \
            np.load(models / "resume.npz") as b:
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    records = _records(tmp_path / "stopped" / "logs" / "resume.jsonl")
    steps = [r for r in records if "train_loss" in r]
    full_steps = [r for r in _records(tmp_path / "full" / "logs" / "resume.jsonl")
                  if "train_loss" in r]
    assert [r["train_loss"] for r in steps] == [r["train_loss"] for r in full_steps]
    assert [r for r in records if r.get("preempted")] != []
    assert sorted(os.listdir(models / "resume")) == ["step_2.pt", "step_3.pt", "step_6.pt"]


def test_weights_only_resume_loads_the_npz(tmp_path):
    # every eval on the same captions, so two evals of one model agree
    first = _resume_config(tmp_path, epochs=1, loss_type="anchor", only_lunif_epochs=0,
                           eval_redraw_captions=False)
    cli.main(first, device="cpu")
    again = dataclasses.replace(first, run_name="again", epochs=1, resume_epoch=1,
                                resume_checkpoint=str(tmp_path / "models" / "resume.npz"))
    cli.main(again, device="cpu")
    records = _records(tmp_path / "logs" / "again.jsonl")
    # the pre-training eval of the resumed run is the final eval of the first
    first_final = [r for r in _records(tmp_path / "logs" / "resume.jsonl") if "gap" in r][-1]
    resumed_first = [r for r in records if "gap" in r][0]
    assert resumed_first["gap"] == first_final["gap"]
    assert len([r for r in records if "train_loss" in r]) == 3  # epochs 1..1 more


@pytest.fixture
def keep_jax_cache():
    """The JAX CLI points XLA's compilation cache at the config's
    directory; put the suite's back afterwards."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)
    compilation_cache.reset_cache()


def test_smoke_tiny_records_equal_the_jax_clis(tmp_path, monkeypatch, keep_jax_cache):
    monkeypatch.chdir(tmp_path)
    jax_cli.cli(["--config", SMOKE_TINY, "--smoke"])
    want = _records(tmp_path / "logs" / "smoke-tiny" / "smoke-tiny-smoke.jsonl")
    os.rename(tmp_path / "logs", tmp_path / "jax_logs")
    os.rename(tmp_path / "models", tmp_path / "jax_models")
    monkeypatch.setattr(cli, "main", functools.partial(cli.main, device="cpu"))
    cli.cli(["--config", SMOKE_TINY, "--smoke"])
    got = _records(tmp_path / "logs" / "smoke-tiny" / "smoke-tiny-smoke.jsonl")
    # the port's first record also names the data routes its loaders took
    routes = {"loader": "threads", "tokenizer": "python", "image": "pil"}
    assert got[0].pop("data_routes") == {"train": routes, "eval": routes}
    # and the world size, the backend and the loss route (one rank, no group)
    assert got[0].pop("parallel") == {"world_size": 1, "backend": None, "loss_route": "kernel"}
    # and each tower's attention route: tiny-test's qkv is far under the
    # 3 MB budget in both compute types
    whole = {"vision": "whole-width", "text": "whole-width"}
    assert got[0].pop("attention_routes") == {"train": whole, "eval": whole}
    assert _shape(got) == _shape(want)
    assert got[0]["config"] == want[0]["config"]
    assert sorted(os.listdir(tmp_path / "models" / "smoke-tiny")) == [
        "smoke-tiny-smoke", "smoke-tiny-smoke.npz", "smoke-tiny-smoke_epoch_1.npz"]
    evals = [r for r in got if "forward_r1" in r]
    assert len(evals) == 3 and all(len(r) == 13 + 1 + 1 for r in evals)  # + _step, _time
    assert all(np.isfinite(list(r.values())).all() for r in evals)


def test_folder_sweep_runs_every_yaml_and_skips_empty(tmp_path, monkeypatch, capsys):
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    base = yaml.safe_load(open(SMOKE_TINY))
    for name, loss in (("a.yaml", "anchor"), ("b.yaml", "ANCHOR(IMAGE,TEXT)+LALIGN(IMAGE,TEXT)")):
        cfg = dict(base, run_name=f"sweep-{name[0]}", loss_type=loss, batch_size=8,
                   num_train_samples=16, num_test_samples=8, plot_embeddings=False,
                   log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "models"))
        (sweep / name).write_text(yaml.safe_dump(cfg))
    (sweep / "all_experiments.yaml").write_text("# TODO\n")
    (sweep / "notes.txt").write_text("ignored")
    monkeypatch.setattr(cli, "main", functools.partial(cli.main, device="cpu"))
    cli.cli(["--config", str(sweep), "--device", "0"])
    assert (tmp_path / "logs" / "sweep-a.jsonl").exists()
    assert (tmp_path / "logs" / "sweep-b.jsonl").exists()
    assert "skipping empty config" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.cli(["--config", str(tmp_path / "nope.yaml")])


def test_refusals(tmp_path, monkeypatch):
    config = load_config(SMOKE_TINY)  # plot_embeddings defaults to true
    # the plots need matplotlib: without it the run is refused by name
    # before any file is written
    find_spec = cli.importlib.util.find_spec
    monkeypatch.setattr(cli.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    with pytest.raises(NotImplementedError, match="matplotlib"):
        cli.main(config, device="cpu")
    monkeypatch.undo()
    assert not os.path.exists("./logs/smoke-tiny/smoke-tiny.jsonl")
    smoke = cli.apply_smoke_overrides(config)
    assert smoke.plot_embeddings is False and smoke.dataset == "synthetic"
    # tokenizer: native runs where g++ builds it; where the build fails it
    # is refused by name before any file is written, as on the JAX side
    from sparsify_clip_tpu_torch.utils import native_build

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX", raising=False)
    logs = tmp_path / "refused"
    with pytest.raises(RuntimeError, match="native tokenizer library unavailable"):
        cli.main(dataclasses.replace(smoke, tokenizer="native", log_dir=str(logs)),
                 device="cpu")
    monkeypatch.undo()
    assert not logs.exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(smoke)  # the card by default


def test_debug_nans_raises_on_a_non_finite_loss():
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import create_train_setup

    batch = synthetic_batch(4, 32, seed=0)
    batch["images"][0, 0, 0, 0] = np.nan
    for debug in (False, True):
        config = ExperimentConfig.from_dict(dict(model="tiny-test", batch_size=4, epochs=1,
                                                 fp16=False, debug_nans=debug))
        setup = create_train_setup(config, steps_per_epoch=2, device="cpu")
        if debug:
            with pytest.raises(FloatingPointError, match="step 0"):
                setup.train_step(setup.state, batch)
            assert setup.state.step == 0
        else:
            _, metrics = setup.train_step(setup.state, batch)
            assert not np.isfinite(float(metrics["train_loss"]))


BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "regex", "PIL", "sparsify_clip_tpu")


def test_the_port_runs_with_jax_regex_pil_and_orbax_blocked(tmp_path):
    """Every module of the port and chip_smoke.py import, and the CLI runs
    smoke_tiny --smoke end to end, in a process where those packages
    cannot be imported."""
    script = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {BLOCKED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
import sparsify_clip_tpu_torch
for info in pkgutil.walk_packages(sparsify_clip_tpu_torch.__path__, "sparsify_clip_tpu_torch."):
    importlib.import_module(info.name)
sys.path.insert(0, {REPO!r})
import chip_smoke
from sparsify_clip_tpu_torch.cli import apply_smoke_overrides, main
from sparsify_clip_tpu_torch.config import load_config
metrics = main(apply_smoke_overrides(load_config({SMOKE_TINY!r})), device="cpu")
assert len(metrics) == 13
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
