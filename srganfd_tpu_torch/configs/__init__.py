"""Experiment configs of the port, by the JAX package's names
(``srganfd_tpu/configs/__init__.py``): every config of the JAX package is
ported."""

import importlib

from srganfd_tpu_torch.configs.base import ExperimentConfig  # noqa: F401

_PORTED = ("rrdbnet", "esrgan", "bsrnet", "bsrgan", "realesrnet", "realesrgan", "aesrgan")


def get_config(name: str, **overrides) -> ExperimentConfig:
    """``srganfd_tpu_torch.configs.<name>``'s config with keyword overrides
    applied (e.g. ``epochs=1``)."""
    if name not in _PORTED:
        raise KeyError(f"unknown config {name!r}; ported: {_PORTED}")
    cfg = importlib.import_module(f"srganfd_tpu_torch.configs.{name}").get_config()
    return cfg.replace(**overrides) if overrides else cfg
