"""CUDA graphs of the trainer's dispatch modes (the counterpart of the JAX
package's one device program a dispatch: ``SRGANFD_FUSE_STEP=1`` compiles
the BSRGAN chain, the crop and the step into one program a branch key,
``SRGANFD_STEPS_PER_DISPATCH=K`` scans K steps into one).

:class:`StepGraphs` keeps one ``torch.cuda.CUDAGraph`` a dispatch signature
(the fused chain's branch key, the generic form's batch shapes, and K), with
static input buffers that each dispatch fills before its ``replay()``: one
dispatch is one replay. The first dispatch of a signature runs eagerly, as
real steps in the device form, and then the graph is captured, so warm-up
applies no update that the JAX run does not; the cuDNN and cuBLAS choices,
the kernels' libraries and every device constant (``ops/consts.py``) exist
before the capture. The capture runs under ``blocks.repack_always()``, so
the RDB kernel's weights are packed inside the graph, after each update;
after each replay the RDB caches are dropped, since a replay bumps no
version counter. A capture that fails raises: there is no eager fallback.

All graphs of a trainer share one memory pool and one stream: they replay
one at a time, and what one graph leaves for the next (parameters, Adam
states, counts, the static buffers) was allocated outside the pool or is
still referenced.
"""

from __future__ import annotations

from typing import Callable

import torch

from srganfd_tpu_torch.models.blocks import repack_always
from srganfd_tpu_torch.ops import consts
from srganfd_tpu_torch.ops.cuda import filter2d as f2d
from srganfd_tpu_torch.ops.cuda import rdb

__all__ = ["StepGraphs"]

Fn = Callable[[list[torch.Tensor]], dict[str, torch.Tensor]]


class _Captured:
    def __init__(self, graph: torch.cuda.CUDAGraph, static_in: list[torch.Tensor],
                 static_out: dict[str, torch.Tensor], launches: dict[str, int], keep: list[torch.Tensor]) -> None:
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches  # kernel launches recorded in the graph: each replay makes them
        self.keep = keep  # the device constants it reads


class StepGraphs:
    """The captured dispatches of one trainer and one state on one card."""

    def __init__(self, device: torch.device, after_replay: Callable[[], None] | None = None) -> None:
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self.after_replay = after_replay
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict[tuple, _Captured] = {}
        self.eager = 0  # dispatches run eagerly (each signature's first)
        self.replays = 0

    def run(self, key: tuple, fn: Fn, inputs: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        """One dispatch of ``fn`` on ``inputs``: eager and then a capture the
        first time ``key`` is seen, a replay after. Returns the metrics."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        for x in inputs:  # made on the caller's stream, read on this one
            x.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            g = self.graphs.get(key)
            if g is None:
                out = fn(inputs)
                self.eager += 1
                self.graphs[key] = self._capture(fn, inputs)
            else:
                for s, x in zip(g.static_in, inputs):
                    s.copy_(x, non_blocking=True)
                g.graph.replay()
                self.replays += 1
                if self.after_replay is not None:
                    self.after_replay()
                out = {k: v.clone() for k, v in g.static_out.items()}
        cur.wait_stream(self.stream)
        for v in out.values():
            v.record_stream(cur)
        return out

    def _capture(self, fn: Fn, inputs: list[torch.Tensor]) -> _Captured:
        static_in = [x.clone() for x in inputs]
        keep = consts.live()
        graph = torch.cuda.CUDAGraph()
        before = (rdb.launches, f2d.launches)
        with repack_always(), torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                               capture_error_mode="thread_local"):
            static_out = fn(static_in)
        launches = {"rdb": rdb.launches - before[0], "filter2d": f2d.launches - before[1]}
        return _Captured(graph, static_in, static_out, launches, keep)

    def stats(self) -> dict:
        """Graphs captured, dispatches run eagerly and replayed, and each
        graph's kernel launches a replay."""
        return {"captured": len(self.graphs), "eager_dispatches": self.eager, "replays": self.replays,
                "launches_per_replay": {repr(k): g.launches for k, g in self.graphs.items()}}
