"""Experiment tracking: a JSONL sink, with MLflow and TensorBoard when
installed (the port's own copy of ``srganfd_tpu/track/tracker.py``, cut to
what ``cli/train.py`` and ``cli/test.py`` call).

Parity target (SURVEY.md §2.7/§5): the reference logs to MLflow
(experiment/run/params/metrics/models, e.g.
``BSRGAN/train_bsrgan.py:125-143,201-230``; run resumption by ``run_id``
with a try/except restart ``:133-137``), TensorBoard scalars
(``ESRGAN/train_esrgan.py:91,444-453``) and the stdout ProgressMeter.

The metric and param names are the JAX package's. The JSONL sink
(``<samples_dir>/logs/<experience_name>/events.jsonl``) is always on, so
every run can be read back; the MLflow and TensorBoard adapters are
imported when a tracker is made, and are active only where the packages
are installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

__all__ = ["Tracker"]


def _optional_mlflow():
    try:
        import mlflow
    except ImportError:
        return None
    return mlflow


def _optional_summary_writer():
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


class Tracker:
    """Fan-out tracker with the reference's logging vocabulary."""

    def __init__(
        self,
        experience_name: str,
        run_name: str = "",
        run_id: str = "",
        samples_dir: str = "samples",
        tags: Any = None,
        description: str = "",
        enabled: bool = True,
    ) -> None:
        """``enabled=False`` makes every sink a no-op: under data
        parallelism only rank 0 writes, as in the JAX trainer."""
        self.dir = os.path.join(samples_dir, "logs", experience_name or "default")
        self._tb = None
        self._mlflow = None
        self._jsonl = None
        self.run_id = run_id
        self.enabled = enabled
        if not enabled:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "events.jsonl"), "a")
        summary_writer = _optional_summary_writer()
        if summary_writer is not None:
            self._tb = summary_writer(self.dir)
        mlflow = _optional_mlflow()
        if mlflow is not None:
            name = experience_name or "default"
            try:
                mlflow.set_experiment(name)
            except Exception:
                # the reference creates the experiment when setting it fails
                # (BSRGAN/train_bsrgan.py:126-130), then sets it so the run
                # lands in it rather than in Default
                mlflow.create_experiment(name)
                mlflow.set_experiment(name)
            kwargs = dict(
                run_id=run_id or None,
                run_name=run_name or None,
                tags=_normalize_tags(tags),
                description=description or None,
            )
            try:
                mlflow.start_run(**kwargs)
            except Exception:
                # the reference recovers from an unclosed previous run the
                # same way (BSRGAN/train_bsrgan.py:133-137)
                mlflow.end_run()
                mlflow.start_run(**kwargs)
            run = mlflow.active_run()
            self.run_id = getattr(getattr(run, "info", None), "run_id", "") or run_id
            self._mlflow = mlflow

    # -- the reference's call sites --------------------------------------------

    def log_params(self, params: dict[str, Any]) -> None:
        self._write({"type": "params", "params": {k: _plain(v) for k, v in params.items()}})
        if self._mlflow is not None:
            self._mlflow.log_params({k: str(v)[:500] for k, v in params.items()})

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        plain = {k: float(v) for k, v in metrics.items()}
        self._write({"type": "metrics", "step": step, "metrics": plain})
        if self._mlflow is not None:
            self._mlflow.log_metrics(plain, step=step)
        if self._tb is not None:
            for k, v in plain.items():
                self._tb.add_scalar(k, v, step)

    def log_artifact(self, path: str, name: str) -> None:
        """A file (the port's checkpoints are single files, where the JAX
        package's are directories) under the artifact path ``name``."""
        self._write({"type": "artifact", "name": name, "path": path})
        if self._mlflow is not None:
            self._mlflow.log_artifact(path, name)

    def log_image(self, image: np.ndarray, name: str) -> None:
        """An HWC RGB image, float in [0, 1] (clipped, scaled to uint8) or
        uint8: a PNG ``<name>.png`` in the log directory, through cv2 (BGR),
        and its JSONL record."""
        if not self.enabled:
            return
        import cv2

        path = os.path.join(self.dir, name.replace("/", "_"))
        if not path.lower().endswith((".png", ".jpg")):
            path += ".png"
        arr = image if image.dtype == np.uint8 else np.clip(image * 255.0, 0, 255).astype(np.uint8)
        cv2.imwrite(path, np.ascontiguousarray(arr[..., ::-1]))
        self._write({"type": "image", "name": name, "path": path})
        if self._mlflow is not None:
            self._mlflow.log_image(image, name if "." in name else name + ".png")

    def log_dict(self, payload: dict[str, Any], name: str) -> None:
        """``payload`` as the JSON file ``<name>.json`` in the log directory."""
        if not self.enabled:
            return
        path = os.path.join(self.dir, name if name.endswith(".json") else name + ".json")
        with open(path, "w") as f:
            json.dump({k: _plain(v) for k, v in payload.items()}, f, indent=2)
        if self._mlflow is not None:
            self._mlflow.log_dict(payload, name)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._mlflow is not None:
            self._mlflow.end_run()
            self._mlflow = None

    # -- internals ----------------------------------------------------------------

    def _write(self, record: dict[str, Any]) -> None:
        if self._jsonl is None:
            return
        record["ts"] = time.time()
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()


def _normalize_tags(tags: Any) -> dict | None:
    """mlflow.start_run takes Dict[str, str] tags; the configs (like the
    reference's ``bsrgan_config.py:75``) declare ``tags`` as a string.
    Parses "k=v,k2=v2", wraps a bare string as {"tag": s}, passes dicts."""
    if not tags:
        return None
    if isinstance(tags, dict):
        return tags
    if isinstance(tags, str):
        if "=" in tags:
            pairs = (item.split("=", 1) for item in tags.split(",") if "=" in item)
            return {k.strip(): v.strip() for k, v in pairs}
        return {"tag": tags}
    return {"tag": str(tags)}


def _plain(v: Any) -> Any:
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v if isinstance(v, (int, float, str, bool, type(None))) else str(v)
