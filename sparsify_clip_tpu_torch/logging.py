"""Run logging, ported from :mod:`sparsify_clip_tpu.logging`: wandb when
available, JSONL always.

The records and keys are the JAX logger's, the reference's
``constrantive_temperature_learnable`` typo included, so a port run's
JSONL reads as a JAX run's.  Values are read with ``float()``, never in
place: the loss wrappers return views made inside a custom autograd
Function, on which an in-place op raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    """wandb-or-JSONL logger with reference-compatible keys."""

    def __init__(
        self,
        project: str,
        run_name: str,
        config: Optional[Dict[str, Any]] = None,
        log_dir: str = "./logs",
        backend: str = "auto",
        start: Optional[Dict[str, Any]] = None,
    ):
        """``start``: fields the ``run_start`` record carries beside the
        config (the CLI's ``data_routes``)."""
        self.run_name = run_name
        self.step = 0
        self._wandb = None
        if backend in ("auto", "wandb"):
            try:
                import wandb  # type: ignore

                self._wandb = wandb
                wandb.init(project=project, config=config, name=run_name)
            except Exception:
                if backend == "wandb":
                    raise
                self._wandb = None
        os.makedirs(log_dir, exist_ok=True)
        safe = run_name.replace("/", "_")
        self._path = os.path.join(log_dir, f"{safe}.jsonl")
        self._fh = open(self._path, "a", buffering=1)
        self.log({"event": "run_start", "config": config or {}, **(start or {})})

    @property
    def path(self) -> str:
        return self._path

    def log(self, metrics: Dict[str, Any]) -> None:
        record = {"_step": self.step, "_time": time.time(), **metrics}
        self._fh.write(json.dumps(record, default=float) + "\n")
        if self._wandb is not None:
            clean = {k: v for k, v in metrics.items() if not k.startswith("_")}
            self._wandb.log(clean)
        self.step += 1

    def log_train_step(
        self,
        metrics: Dict[str, Any],
        temperature_learnable: bool,
        include_components: bool = False,
    ) -> None:
        """Per-step schema parity (sparsify_clip.py:943-951): learnable
        runs log the temperature under the reference's typo'd key;
        fixed-temperature runs log beta/alpha.  ``include_components``
        (config ``log_loss_components``) adds the per-term scalars."""
        if temperature_learnable:
            record = {
                "train_loss": float(metrics["train_loss"]),
                "constrantive_temperature_learnable": float(metrics["temperature"]),
                "learning_rate": float(metrics["learning_rate"]),
            }
        else:
            record = {
                "train_loss": float(metrics["train_loss"]),
                "learning_rate": float(metrics["learning_rate"]),
                "beta": float(metrics["beta"]),
                "alpha": float(metrics["alpha"]),
            }
        for key in ("siglip_scale", "siglip_bias"):
            if key in metrics:
                record[key] = float(metrics[key])
        if include_components:
            for key in ("anchor", "lalign", "lunif"):
                if key in metrics:
                    record[key] = float(metrics[key])
        self.log(record)

    def log_image(self, key: str, path: str) -> None:
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Image(path)})
        self.log({"event": "image", "key": key, "path": path})

    def save_artifact(self, path: str) -> None:
        """Attach a file to the run (the reference's final-model
        ``wandb.save``); always recorded in the JSONL stream as well."""
        if self._wandb is not None:
            try:
                self._wandb.save(path)
            except Exception:
                pass  # artifact upload failure must not kill the run
        self.log({"event": "artifact", "path": os.path.abspath(path)})

    def finish(self) -> None:
        self.log({"event": "run_end"})
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """RunLogger-shaped sink that records nothing (the JAX logger of a
    non-primary process)."""

    path = ""

    def log(self, metrics: Dict[str, Any]) -> None:
        pass

    def log_train_step(self, metrics: Dict[str, Any], temperature_learnable: bool,
                       include_components: bool = False) -> None:
        pass

    def log_image(self, key: str, path: str) -> None:
        pass

    def save_artifact(self, path: str) -> None:
        pass

    def finish(self) -> None:
        pass
