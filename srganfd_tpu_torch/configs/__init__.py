"""Experiment configs of the port, by the JAX package's names
(``srganfd_tpu/configs/__init__.py``). ``bsrnet``, ``bsrgan``,
``realesrnet``, ``realesrgan`` and ``aesrgan`` are ported; the other names
of the JAX package raise with the ROADMAP.md item that ports them."""

import importlib

from srganfd_tpu_torch.configs.base import ExperimentConfig  # noqa: F401

_PORTED = ("bsrnet", "bsrgan", "realesrnet", "realesrgan", "aesrgan")
_NOT_PORTED = {
    "rrdbnet": "A8 (other families)",
    "esrgan": "A8 (other families)",
}


def get_config(name: str, **overrides) -> ExperimentConfig:
    """``srganfd_tpu_torch.configs.<name>``'s config with keyword overrides
    applied (e.g. ``epochs=1``)."""
    if name in _NOT_PORTED:
        raise KeyError(f"config {name!r} is not ported to srganfd_tpu_torch yet: see ROADMAP.md "
                       f"{_NOT_PORTED[name]}")
    if name not in _PORTED:
        raise KeyError(f"unknown config {name!r}; ported: {_PORTED}")
    cfg = importlib.import_module(f"srganfd_tpu_torch.configs.{name}").get_config()
    return cfg.replace(**overrides) if overrides else cfg
