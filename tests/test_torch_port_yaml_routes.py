"""The repository's ``configs/rn50_tpu_baseline.yaml`` and
``configs/vitl14_single_chip.yaml`` through the port on the CPU: both load
through the port's config and pass the CLI's and the step's support
checks, and the CLI runs the RN50 YAML's data fields (``tokenizer:
auto``, ``image_backend: auto``, ``device_augment: true``) with the model
cut to ``tiny-test`` at a small batch, naming the routes it took in its
first record.  The full-width runs are ``chip_smoke.py`` phases 37 and 39.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from sparsify_clip_tpu.config import load_config as jax_load_config
from sparsify_clip_tpu_torch import cli
from sparsify_clip_tpu_torch.config import load_config
from sparsify_clip_tpu_torch.text import native
from sparsify_clip_tpu_torch.train import check_supported

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.mark.parametrize("name", ["rn50_tpu_baseline.yaml", "vitl14_single_chip.yaml"])
def test_the_yaml_loads_and_passes_both_checks(name):
    path = os.path.join(REPO, "configs", name)
    config = load_config(path)
    assert config.to_dict() == jax_load_config(path).to_dict()
    cli._check_supported(config)
    check_supported(config)


def test_the_cli_runs_the_rn50_yamls_data_fields_and_names_its_routes(tmp_path):
    config = load_config(os.path.join(REPO, "configs", "rn50_tpu_baseline.yaml"))
    assert (config.tokenizer, config.image_backend, config.device_augment) == ("auto", "auto", True)
    small = dataclasses.replace(
        config, model="tiny-test", batch_size=8, num_train_samples=16, num_test_samples=8,
        epochs=1, dataset="synthetic", device_augment_staging=40, resume_checkpoint=False,
        plot_embeddings=False, log_backend="jsonl", log_dir=str(tmp_path / "logs"),
        checkpoint_dir=str(tmp_path / "models"))
    cli.main(small, device="cpu", image_size=32)
    with open(tmp_path / "logs" / f"{config.run_name}.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert records[0]["event"] == "run_start"
    assert records[0]["config"]["tokenizer"] == "auto"
    # auto: the native tokenizer where g++ builds it; the synthetic set
    # hands out no JPEG bytes, so the images take the PIL/numpy route
    want = {"loader": "threads", "image": "pil",
            "tokenizer": "native" if native.ensure_built() else "python"}
    assert records[0]["data_routes"] == {"train": want, "eval": want}
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
