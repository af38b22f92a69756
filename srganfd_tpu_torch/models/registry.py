"""String-keyed architecture registry (counterpart of
``srganfd_tpu/models/registry.py``): the same names build the port's
``nn.Module``s."""

from __future__ import annotations

import inspect
import sys
from typing import Any, Callable

_REGISTRY: dict[str, Callable[..., Any]] = {}

# archs of the JAX package that the port has not built yet -> the ROADMAP.md
# item that ports them
_NOT_PORTED = {
    "discriminator_unet_sa": "A4 (with the flash-attention backward, B4)",
    "discriminator": "A8 (other families)",
}


def register(name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        if name in _REGISTRY:
            raise ValueError(f"duplicate arch name {name!r}")
        _REGISTRY[name] = fn
        return fn

    return deco


def check_ported(arch_name: str) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for an arch of
    the JAX package that the port has not built yet, and KeyError for an
    unknown one."""
    if arch_name in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_name!r} is not ported to srganfd_tpu_torch yet: "
                                  f"see ROADMAP.md {_NOT_PORTED[arch_name]}")
    if arch_name not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_name!r}; available: {sorted(_REGISTRY)}")


def create_model(arch_name: str, **kwargs: Any):
    """Instantiate a module by its reference-compatible arch name
    (e.g. ``rrdbnet_x4``, ``bsrgan_x2``, ``discriminator_unet``)."""
    check_ported(arch_name)
    return _REGISTRY[arch_name](**kwargs)


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def arch_accepts(arch_name: str, field: str) -> bool:
    """True if the arch's module class takes ``field`` as a constructor
    argument. Resolved from the factory's return annotation (the factories
    are thin ``**kw`` pass-throughs); False when it cannot be resolved."""
    factory = _REGISTRY.get(arch_name)
    if factory is None:
        return False
    ann = inspect.signature(factory).return_annotation
    if isinstance(ann, str):  # from __future__ import annotations
        ann = getattr(sys.modules.get(factory.__module__), ann, None)
    if not inspect.isclass(ann):
        return False
    return field in inspect.signature(ann.__init__).parameters
