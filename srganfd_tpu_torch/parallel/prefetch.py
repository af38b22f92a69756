"""Host-to-device prefetch (counterpart of ``srganfd_tpu/parallel/prefetch.py``).

Parity target: the reference's ``CUDAPrefetcher`` (``ESRGAN/dataset.py:196-236``),
which overlaps the host-to-device copies with compute on a side CUDA
stream; the JAX package stands in for it with asynchronous ``device_put``.
Here, on the card, ``prefetch_to_device`` keeps ``size`` batches' copies in
flight: each is a ``non_blocking`` copy from page-locked memory on a side
stream, an event marks its end, and the consumer's stream waits for that
event before it reads the batch. A CPU target passes tensors through.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from srganfd_tpu_torch.parallel.mesh import Mesh

__all__ = ["prefetch_to_device", "CPUPrefetcher"]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _own_row(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's row of ``x``'s leading axis, split evenly over ``axis``."""
    rows, index = mesh.size(axis), mesh.index(axis)
    if x.shape[0] % rows:
        raise ValueError(f"batch of {x.shape[0]} does not split over the {rows} rows of the {axis!r} axis")
    per = x.shape[0] // rows
    return x[index * per:(index + 1) * per]


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    mesh: Mesh | None = None,
    axis: str = "data",
    device: torch.device | str | None = None,
) -> Iterator[Any]:
    """Yield device-resident batches (dicts, lists or tuples of arrays or
    tensors), keeping ``size`` transfers in flight. ``device``: the current
    CUDA device when None and CUDA is available, else the CPU. With a mesh
    each rank keeps its own row of each batch's leading axis on ``axis``.

    A yielded batch's copy has ended on the host's clock too, so a loader
    may write its page-locked source again (``NativeBatchLoader``'s ring)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    device = torch.device(device)

    def host(x: Any) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return _own_row(t, mesh, axis) if mesh is not None else t

    if device.type != "cuda":
        for batch in iterator:
            yield _map(lambda x: host(x).to(device), batch)
        return

    side = torch.cuda.Stream(device)

    def put(batch: Any) -> tuple[Any, torch.cuda.Event]:
        def copy(x: Any) -> torch.Tensor:
            t = host(x)
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        with torch.cuda.stream(side):
            out = _map(copy, batch)
            done = torch.cuda.Event()
            done.record(side)
        # the copies' memory belongs to the side stream's allocations: mark
        # its use on the consumer's stream so that it is not reused early
        _map(lambda t: t.record_stream(torch.cuda.current_stream(device)), out)
        return out, done

    buf: collections.deque = collections.deque()
    it = iter(iterator)
    try:
        while len(buf) < size:
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out, done = buf.popleft()
        done.synchronize()  # the host source may be written again
        torch.cuda.current_stream(device).wait_event(done)
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out


class CPUPrefetcher:
    """The reference's ``.next()`` / ``.reset()`` iterator protocol
    (``ESRGAN/dataset.py:172-193``)."""

    def __init__(self, loader: Iterable[Any]) -> None:
        self.loader = loader
        self.it = iter(loader)

    def next(self) -> Any | None:
        try:
            return next(self.it)
        except StopIteration:
            return None

    def reset(self) -> None:
        self.it = iter(self.loader)

    def __len__(self) -> int:
        return len(self.loader)  # type: ignore[arg-type]
