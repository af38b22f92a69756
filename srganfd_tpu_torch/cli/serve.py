"""Persistent super-resolution serving daemon of the port (counterpart of
``srganfd_tpu/cli/serve.py``, same protocol and flags).

The model is built once and stays resident on the device; requests
stream in over a transport and SR frames stream out.

Transports (pick one):
  --stdio            JSONL on stdin/stdout. One request per line:
                       {"input": "lr.png", "output": "sr.png"[, "id": x]}
                     replied with
                       {"id", "output", "ms", "in_hw", "out_hw", "ok"}
                     EOF or {"cmd": "shutdown"} stops the daemon;
                     {"cmd": "stats"} replies with the counters.
  --watch DIR        poll DIR for new/updated frames; SR each into
                     --output DIR (same basename). ``--once`` drains the
                     backlog and exits (cron mode).
  --port N           HTTP: POST /sr with an encoded image body returns
                     the SR PNG; GET /healthz -> 200 "ok"; GET /stats ->
                     JSON counters. Single-threaded by default (one card
                     runs one forward at a time); ``--batch auto`` threads
                     the server and micro-batches concurrent requests.

Behaviours:
  - ``--bucket M`` reflect-pads inputs up to multiples of M and crops the
    output back to scale * the true size; seam effects stay within the
    generator's receptive field at the padded edge (``--bucket 0`` runs
    exact shapes).
  - ``--warmup HxW[,HxW...]`` runs the hot shapes once before the
    transport opens (kernel build, cuDNN set-up).
  - ``--batch N``: watch-mode backlogs drain in batched calls; same-shape
    frames stack into one forward, ragged tails repeat-pad to N.
    ``--batch auto`` uses the 16/8/1 drain ladder of the JAX daemon.
  - ``--half`` serves in bfloat16; ``--quant-int8`` serves the RDB trunk
    in int8 (the s8 tensor-core kernel, ``ops/quant.py``); ``--self-ensemble``
    and ``--tile`` compose like the one-shot CLI.
  - ``--attn-chunk N [--attn-backend flash]``: attention-bearing archs
    (``bsrgantrans_x2``) run exact attention in query chunks, through the
    hand-written kernel with ``flash``. ``bsrgantrans_x2`` needs even frame
    sizes, which ``--bucket 2`` (or any even bucket) gives.
  - request latency percentiles (p50/p95) are reported on shutdown, by
    ``{"cmd": "stats"}`` and at GET /stats.
  - ``--spatial-shard [--cp-backend ring|ulysses]`` under ``torchrun``
    (one process per GPU): each frame's rows shard over the ranks
    (``parallel/spatial.py``), the transformer archs' attention running
    over all of them. Rank 0 owns the transport and sends each frame's
    shape and pixels to the others, which loop on them
    (``ServingEngine.follow``). While no frame comes, rank 0 sends an empty
    header every ``KEEPALIVE_S`` seconds, so that the others, waiting in a
    collective, never reach the group's timeout. Its shutdown, or a
    SIGTERM that reached any rank (sent to rank 0 with the next header),
    releases every rank.
    Exclusive with ``--tile``, as in JAX.

Overload limits (HTTP transport):
  - POST bodies above ``--max-body-mb`` (default 64) get 413 before the
    body is read.
  - with ``--batch auto`` the micro-batcher's queue holds at most
    ``--max-queue`` frames (default 32); a request that finds it full gets
    503 + ``Retry-After: 1`` instead of queueing a decoded frame without
    limit. GET /stats reports both rejection counts.

One thread runs the model: the micro-batcher's dispatcher with ``--batch
auto``, else the thread that serves. Each makes the engine's device its
current one first. A failed forward answers every request it carried with
500; nothing falls back to the CPU.

Runs on ``cuda`` unless ``--device-type cpu`` is given.
"""

from __future__ import annotations

import argparse
import http.server
import json
import os
import queue
import sys
import threading
import time

import cv2
import numpy as np
import torch

from srganfd_tpu_torch.cli.infer import (
    add_attention_flags,
    add_parallel_flags,
    add_quant_flag,
    attention_kwargs,
    build_model,
    choice_device,
    make_apply,
    quant_kwargs,
    spatial_plan,
)
from srganfd_tpu_torch.data.datasets import list_image_files, load_image_rgb
from srganfd_tpu_torch.parallel import comm
from srganfd_tpu_torch.parallel.mesh import maybe_init_distributed

__all__ = ["ServingEngine", "OverloadedError", "serve_stdio", "serve_watch", "serve_http", "main"]

# --spatial-shard: seconds between rank 0's empty headers while the
# transport is idle, well inside the group's timeout (parallel/mesh.py
# INIT_TIMEOUT_S, 300 s), which ends a collective that waits longer
KEEPALIVE_S = 30.0


def _pad_to_multiple(img: np.ndarray, mult: int) -> tuple[np.ndarray, int, int]:
    """Reflect-pad HWC to the next (mult, mult) multiple; returns the true
    (h, w) for crop-back."""
    h, w = img.shape[:2]
    if mult <= 1:
        return img, h, w
    ph = (-h) % mult
    pw = (-w) % mult
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    return img, h, w


def _batch_arg(v: str):
    """argparse type for --batch: 'auto' or a positive int."""
    if v == "auto":
        return v
    try:
        n = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--batch must be an int or 'auto', got {v!r}")
    if n < 1:
        raise argparse.ArgumentTypeError("--batch must be >= 1")
    return n


def _auto_drain_chunks(n: int) -> list[int]:
    """Backlog-drain ladder of ``--batch auto``: 16s while >= 15 frames
    remain, then at most one 8, then singles. The ladder is the JAX
    daemon's, kept for protocol parity; it has not been measured on the
    H100 (ROADMAP.md A3)."""
    out: list[int] = []
    while n >= 15:
        out.append(16)
        n -= min(n, 16)
    if n >= 8:
        out.append(8)
        n -= 8
    out.extend([1] * n)
    return out


class ServingEngine:
    """Resident model + request statistics."""

    def __init__(
        self,
        arch: str,
        weights: str = "",
        use_ema: bool = False,
        half: bool = False,
        quant_int8: bool = False,
        self_ensemble: bool = False,
        tile: int = 0,
        tile_overlap: int = 16,
        bucket: int = 0,
        batch: int | str = 1,
        attn_chunk: int = 0,
        attn_backend: str | None = None,
        model_kwargs: dict | None = None,
        device: str = "cuda",
        seed: int = 0,
        spatial_shard: bool = False,
        cp_backend: str = "ring",
    ) -> None:
        if spatial_shard and tile:
            raise ValueError("--spatial-shard and --tile are mutually exclusive")
        self.device = choice_device(device)
        self.spatial = bool(spatial_shard)
        if self.spatial:
            maybe_init_distributed(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        kwargs = {**quant_kwargs(arch, quant_int8), **attention_kwargs(arch, attn_chunk, attn_backend),
                  **(model_kwargs or {})}
        # each frame's rows shard over the ranks with a halo exchange
        # (parallel/spatial.py), the serving form of infer --spatial-shard
        self._halo, self._row_multiple, cp_kwargs = spatial_plan(arch, int(tile_overlap), cp_backend)
        if self.spatial:
            kwargs.update(cp_kwargs)
        self.rank, self.world = comm.rank(), comm.world()
        # the frames' header and pixels travel on the card under NCCL and
        # through host memory under gloo, where they come from anyway
        self._wire = self.device if comm.backend() == "nccl" else torch.device("cpu")
        self.peer_stop = False  # a rank other than 0 asked to drain (its SIGTERM)
        self.stop_flag = False  # this rank's own drain request, sent with the next header
        # rank 0: one header and its frame at a time (the keep-alive thread sends headers too)
        self._wire_lock = threading.Lock()
        self._closed = threading.Event()
        self.model = build_model(
            arch, self.device, weights, use_ema, half, model_kwargs=kwargs, seed=seed
        )
        self._apply = make_apply(self.model, self.device)
        self.upscale = int(self.model.upscale)
        self.bucket = int(bucket)
        self.batch = "auto" if batch == "auto" else max(1, int(batch))
        self.tile = int(tile)
        self.tile_overlap = int(tile_overlap)
        self.self_ensemble = bool(self_ensemble)

        self.served = 0
        self.failed = 0
        self.rejected = 0  # HTTP: 503, the micro-batcher's queue full
        self.rejected_oversize = 0  # HTTP: 413, a body over the cap
        self.latencies_ms: list[float] = []
        self._shapes: set[tuple[int, int]] = set()
        self.stats_lock = threading.Lock()
        self._keepalive = None
        if self.spatial and self.world > 1 and self.rank == 0:
            self._keepalive = threading.Thread(target=self._keep_alive, daemon=True)
            self._keepalive.start()

    # -- core -------------------------------------------------------------
    def use_device(self) -> None:
        """Make the engine's card the calling thread's current device: a
        thread starts on device 0, and the kernels launch on the current
        one."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _spatial_sr(self, padded: np.ndarray) -> np.ndarray:
        """The sharded forward of one frame, which every rank runs."""
        from srganfd_tpu_torch.parallel.spatial import spatial_sharded_sr

        run_one = lambda im: spatial_sharded_sr(  # noqa: E731
            self.model, im, self.upscale, halo=self._halo, row_multiple=self._row_multiple, device=self.device)
        if self.self_ensemble:
            from srganfd_tpu_torch.ops.self_ensemble import self_ensemble

            return self_ensemble(run_one, padded)
        return run_one(padded)

    def _header(self, cmd: int, h: int = 0, w: int = 0) -> tuple[int, int, int]:
        """One header over the ranks: rank 0 gives (cmd, h, w) with cmd 1
        for a frame, 2 for none (the keep-alive) and 0 to stop, the others
        zeros; every rank adds its drain request. An all-reduce of the max,
        so a SIGTERM that reached any rank reaches rank 0 with the next
        header."""
        t = torch.tensor([cmd, h, w, int(self.stop_flag)], dtype=torch.int64, device=self._wire)
        got = [int(v) for v in comm.all_reduce(t, "max").tolist()]
        self.peer_stop = self.peer_stop or bool(got[3])
        return got[0], got[1], got[2]

    def _frame(self, padded: np.ndarray | None, h: int, w: int) -> np.ndarray:
        """Rank 0's padded frame on every rank (a broadcast of its pixels)."""
        buf = torch.empty((h, w, 3), dtype=torch.float32, device=self._wire)
        if self.rank == 0:
            buf.copy_(torch.from_numpy(np.ascontiguousarray(padded, np.float32)))
        return comm.broadcast(buf, 0).cpu().numpy()

    def _keep_alive(self) -> None:
        """Rank 0's thread: an empty header every ``KEEPALIVE_S`` seconds
        until :meth:`close`, so that the ranks in :meth:`follow` wait for
        the next frame in collectives that each end within the group's
        timeout."""
        self.use_device()
        while not self._closed.wait(KEEPALIVE_S):
            with self._wire_lock:
                if self._closed.is_set():
                    return
                self._header(2)

    def follow(self) -> None:
        """The serving loop of a rank other than 0 under ``--spatial-shard``:
        take each frame rank 0 sends, run its shard, until rank 0 sends the
        stop. A failed forward is rank 0's to answer; this rank goes on to
        the next frame."""
        self.use_device()
        while True:
            cmd, h, w = self._header(0)
            if cmd == 0:
                return
            if cmd == 2:  # rank 0's keep-alive: no frame
                continue
            frame = self._frame(None, h, w)
            try:
                self._spatial_sr(frame)
            except Exception as e:  # noqa: BLE001 - rank 0 answers the request
                print(f"rank {self.rank}: frame failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def close(self) -> None:
        """Rank 0 stops its keep-alive and releases the ranks that
        ``follow`` (a no-op otherwise, and when called again)."""
        if self._keepalive is None or self._closed.is_set():
            return
        self._closed.set()
        with self._wire_lock:
            self._header(0)
        self._keepalive.join()

    def sr_array(self, img: np.ndarray) -> np.ndarray:
        """float32 HWC [0,1] -> SR HWC [0,1]; pads to the bucket, crops
        back to ``upscale * true_size``."""
        padded, h, w = _pad_to_multiple(img, self.bucket)
        with self.stats_lock:
            self._shapes.add(padded.shape[:2])
        if self.spatial:
            with self._wire_lock:
                if self.world > 1:  # the other ranks wait in follow() for this frame
                    self._header(1, *padded.shape[:2])
                    padded = self._frame(padded, *padded.shape[:2])
                sr = self._spatial_sr(padded)
        elif self.tile:
            from srganfd_tpu_torch.parallel.tiled_inference import tiled_sr

            run_one = lambda im: tiled_sr(
                self._apply, im, self.upscale, tile=self.tile, overlap=self.tile_overlap
            )
            if self.self_ensemble:
                from srganfd_tpu_torch.ops.self_ensemble import self_ensemble

                sr = self_ensemble(run_one, padded)
            else:
                sr = run_one(padded)
        elif self.self_ensemble:
            from srganfd_tpu_torch.ops.self_ensemble import self_ensemble_batched

            sr = self_ensemble_batched(self._apply, padded)
        else:
            sr = self._apply(padded[None])[0]
        return np.asarray(sr, np.float32)[: h * self.upscale, : w * self.upscale]

    def sr_batch(self, imgs: list[np.ndarray]) -> list[np.ndarray]:
        """SR a list of frames with fixed-size batched calls.

        Frames pad to the bucket and group by padded shape; each group runs
        in stacks padded (by repeating the last frame) to exactly
        ``self.batch`` rows. Per-frame modes (tile / self-ensemble) and
        ``batch <= 1`` go through ``sr_array``.
        """
        per_frame = (self.batch != "auto" and self.batch <= 1) or self.tile or self.self_ensemble or self.spatial
        if per_frame:
            return [self.sr_array(im) for im in imgs]
        padded = [_pad_to_multiple(im, self.bucket) for im in imgs]
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (p, _, _) in enumerate(padded):
            groups.setdefault(p.shape[:2], []).append(i)
        out: list[np.ndarray | None] = [None] * len(imgs)
        for shape, idxs in groups.items():
            with self.stats_lock:
                self._shapes.add(shape)
            if self.batch == "auto":
                plan = _auto_drain_chunks(len(idxs))
            else:
                plan = [self.batch] * -(-len(idxs) // self.batch)
            pos = 0
            for bsz in plan:
                chunk = idxs[pos : pos + bsz]
                pos += bsz
                stack = np.stack([padded[i][0] for i in chunk])
                if len(chunk) < bsz:  # ragged tail: repeat-pad
                    pad = np.repeat(stack[-1:], bsz - len(chunk), axis=0)
                    stack = np.concatenate([stack, pad], axis=0)
                sr = self._apply(stack)
                for j, i in enumerate(chunk):
                    _, h, w = padded[i]
                    out[i] = np.asarray(sr[j], np.float32)[: h * self.upscale, : w * self.upscale]
        return out  # type: ignore[return-value]

    def _encode(self, sr: np.ndarray, out_path: str) -> np.ndarray:
        sr8 = np.clip(sr * 255.0, 0, 255).astype(np.uint8)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        if not cv2.imwrite(out_path, sr8[..., ::-1]):
            raise IOError(f"failed to encode {out_path}")
        return sr8

    def sr_files_batched(self, pairs: list[tuple[str, str]]) -> list[dict]:
        """Decode -> batched SR -> encode for (in_path, out_path) pairs.

        Per-file decode/encode failures yield ``{"ok": False}`` replies
        without poisoning the rest of the batch. Latency is the batch
        wall-clock split evenly over its frames.
        """
        t0 = time.perf_counter()
        imgs: list[np.ndarray] = []
        live: list[int] = []
        replies: list[dict] = [None] * len(pairs)  # type: ignore[list-item]
        for i, (in_path, _) in enumerate(pairs):
            try:
                imgs.append(load_image_rgb(in_path))
                live.append(i)
            except (IOError, cv2.error) as e:  # a bad frame must not kill the batch
                self.failed += 1
                replies[i] = {"ok": False, "error": str(e)[:300]}
        srs = self.sr_batch(imgs) if imgs else []
        for img, sr, i in zip(imgs, srs, live):
            try:
                sr8 = self._encode(sr, pairs[i][1])
            except (IOError, OSError, cv2.error) as e:
                self.failed += 1
                replies[i] = {"ok": False, "error": str(e)[:300]}
                continue
            replies[i] = {
                "output": pairs[i][1],
                "in_hw": list(img.shape[:2]),
                "out_hw": list(sr8.shape[:2]),
                "ok": True,
            }
        per_frame_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(live))
        for i in live:
            if replies[i]["ok"]:
                with self.stats_lock:
                    self.served += 1
                    self.latencies_ms.append(per_frame_ms)
                replies[i]["ms"] = round(per_frame_ms, 2)
        return replies

    def sr_file(self, in_path: str, out_path: str) -> dict:
        """Decode -> SR -> encode; returns the reply record."""
        t0 = time.perf_counter()
        img = load_image_rgb(in_path)
        sr8 = self._encode(self.sr_array(img), out_path)
        ms = (time.perf_counter() - t0) * 1e3
        with self.stats_lock:
            self.served += 1
            self.latencies_ms.append(ms)
        return {
            "output": out_path,
            "ms": round(ms, 2),
            "in_hw": list(img.shape[:2]),
            "out_hw": list(sr8.shape[:2]),
            "ok": True,
        }

    def warmup(self, shapes: list[tuple[int, int]]) -> None:
        for h, w in shapes:
            t0 = time.perf_counter()
            self.sr_array(np.zeros((h, w, 3), np.float32))
            print(f"warmup {h}x{w}: {(time.perf_counter() - t0):.1f}s", file=sys.stderr, flush=True)
        self.served = 0
        self.latencies_ms.clear()

    def stats(self) -> dict:
        with self.stats_lock:
            lat = sorted(self.latencies_ms)
            served, failed = self.served, self.failed
            rejected, oversize = self.rejected, self.rejected_oversize
            shapes = sorted(self._shapes)
        pick = lambda q: round(lat[min(len(lat) - 1, int(q * len(lat)))], 2) if lat else None
        return {
            "served": served,
            "failed": failed,
            "rejected": rejected,
            "rejected_oversize": oversize,
            "p50_ms": pick(0.50),
            "p95_ms": pick(0.95),
            # input shapes served (the JAX daemon's compiled-program count)
            "compiled_shapes": shapes,
            "upscale": self.upscale,
        }


# -- transports -----------------------------------------------------------


def serve_stdio(engine: ServingEngine, inp=None, out=None, should_stop=None) -> None:
    """JSONL request/reply loop; injectable streams for tests.
    ``should_stop``, asked before each line, ends the loop early (another
    rank's drain under ``--spatial-shard``)."""
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    for line in inp:
        if should_stop is not None and should_stop():
            break
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}), file=out, flush=True)
            engine.failed += 1
            continue
        if req.get("cmd") == "shutdown":
            break
        if req.get("cmd") == "stats":
            print(json.dumps(engine.stats()), file=out, flush=True)
            continue
        try:
            reply = engine.sr_file(req["input"], req["output"])
        except Exception as e:  # noqa: BLE001 — a bad frame must not kill the daemon
            engine.failed += 1
            reply = {"ok": False, "error": str(e)[:300]}
        if "id" in req:
            reply["id"] = req["id"]
        print(json.dumps(reply), file=out, flush=True)


def serve_watch(
    engine: ServingEngine, in_dir: str, out_dir: str,
    poll_s: float = 0.5, once: bool = False, should_stop=None,
) -> int:
    """Poll ``in_dir``; SR any new/updated frame into ``out_dir``. A frame
    is picked up when its mtime settles (two consecutive polls equal) so
    half-written files are not decoded mid-copy. Frames whose output
    already exists and is at least as new as the input are skipped, so
    restarts and ``--once`` passes are idempotent."""
    seen: dict[str, float] = {}
    pending: dict[str, float] = {}
    done = 0
    while True:
        ready: list[tuple[str, str, float]] = []
        for p in list_image_files(in_dir):
            try:
                mt = os.path.getmtime(p)
            except OSError:
                continue
            if seen.get(p) == mt:
                continue
            out_p = os.path.join(out_dir, os.path.basename(p))
            if os.path.exists(out_p) and os.path.getmtime(out_p) >= mt:
                seen[p] = mt
                continue
            if pending.get(p) == mt or once:
                ready.append((p, out_p, mt))
            else:
                pending[p] = mt  # wait one poll for the mtime to settle
        if ready:
            replies = engine.sr_files_batched([(p, out_p) for p, out_p, _ in ready])
            for (p, _, mt), reply in zip(ready, replies):
                seen[p] = mt
                pending.pop(p, None)
                done += 1
                if reply.get("ok"):
                    print(json.dumps({"input": p, **reply}), flush=True)
                else:
                    print(f"! {p}: {reply.get('error')}", file=sys.stderr, flush=True)
        if once:
            return done
        if should_stop is not None and should_stop():
            return done
        time.sleep(poll_s)


class OverloadedError(RuntimeError):
    """Raised by :meth:`_MicroBatcher.submit` when the bounded request
    queue is full; the HTTP handler answers 503 + Retry-After."""


class _MicroBatcher:
    """Cross-request batching for the HTTP transport.

    Concurrent ``POST /sr`` requests enqueue their decoded frames; one
    dispatcher thread, the only one that runs the model, groups them and
    pushes the group through :meth:`ServingEngine.sr_batch`, whose
    ``auto`` ladder sizes the forwards (frames of other padded shapes are
    forwards of their own). A request that arrives alone dispatches at
    once; only when a burst is already queued does the dispatcher hold the
    window open up to ``max_wait_ms`` for stragglers.

    The queue holds at most ``max_queue`` waiting frames, each a decoded
    float32 frame: when it is full, ``submit`` raises
    :class:`OverloadedError` at once instead of blocking the handler
    thread. A dispatch error reaches every request of the group.
    ``close`` (the SIGTERM drain) refuses new frames, lets the dispatcher
    serve what is queued, then stops it."""

    def __init__(self, engine: ServingEngine, max_wait_ms: float = 8.0, max_queue: int = 32) -> None:
        self.engine = engine
        self.q: queue.Queue = queue.Queue(maxsize=max(1, int(max_queue)))
        self.max_wait = max_wait_ms / 1e3
        self._closed = threading.Event()
        self._lock = threading.Lock()  # no frame is queued once close has begun
        self._thread = threading.Thread(target=self._loop, name="sr-dispatch", daemon=True)
        self._thread.start()

    def submit(self, img: np.ndarray) -> np.ndarray:
        slot: dict = {"ev": threading.Event()}
        with self._lock:
            if self._closed.is_set():
                raise OverloadedError("server shutting down")
            try:
                self.q.put_nowait((img, slot))
            except queue.Full:
                raise OverloadedError(f"micro-batcher queue full ({self.q.maxsize} waiting)") from None
        slot["ev"].wait()
        if "err" in slot:
            raise RuntimeError(slot["err"])
        return slot["out"]

    def close(self, timeout: float = 60.0) -> None:
        with self._lock:
            self._closed.set()
        self._thread.join(timeout)
        while True:  # left only if the join timed out
            try:
                _, slot = self.q.get_nowait()
            except queue.Empty:
                return
            slot["err"] = "server shutting down"
            slot["ev"].set()

    def _loop(self) -> None:
        while True:
            try:
                batch = [self.q.get(timeout=0.2)]
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if not self.q.empty():  # a burst in flight: let stragglers join
                deadline = time.perf_counter() + self.max_wait
                while (rem := deadline - time.perf_counter()) > 0:
                    try:
                        batch.append(self.q.get(timeout=rem))
                    except queue.Empty:
                        break
            try:
                self.engine.use_device()
                outs = self.engine.sr_batch([img for img, _ in batch])
            except Exception as e:  # noqa: BLE001 - delivered to every waiter
                for _, slot in batch:
                    slot["err"] = f"{type(e).__name__}: {e}"
                    slot["ev"].set()
                continue
            for (_, slot), out in zip(batch, outs):
                slot["out"] = out
                slot["ev"].set()


def serve_http(
    engine: ServingEngine,
    port: int,
    host: str = "127.0.0.1",
    max_body_bytes: int = 64 * 1024 * 1024,
    max_queue: int = 32,
    should_stop=None,
    ready=None,
) -> None:
    """Stdlib HTTP server: POST /sr (an image body cv2 decodes) -> PNG;
    GET /healthz, GET /stats. With ``engine.batch == "auto"`` it threads
    per request and a :class:`_MicroBatcher` groups concurrent frames;
    otherwise it is single-threaded and runs ``sr_array`` itself (a fixed
    ``--batch N`` would repeat-pad a lone request to N frames).

    Answers: 413 for a ``Content-Length`` outside [0, ``max_body_bytes``],
    before any read (``rejected_oversize``); 400 for an undecodable body
    (``failed``); 503 + ``Retry-After: 1`` when the queue is full
    (``rejected``); 500 for an engine or encode error (``failed``); else
    200 with the PNG, its latency in ``latencies_ms``. ``should_stop``, a
    callable polled every 0.2 s, shuts the server down (the SIGTERM drain);
    ``ready``, if given, is called with the bound (host, port) once the
    socket listens (port 0 picks a free one)."""
    stats_lock = engine.stats_lock  # the handler threads share the counters
    batcher = _MicroBatcher(engine, max_queue=max_queue) if engine.batch == "auto" else None

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet: the stats cover it
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra_headers: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _count(self, field: str) -> None:
            with stats_lock:
                setattr(engine, field, getattr(engine, field) + 1)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                stats = engine.stats()
                if batcher is not None:  # live overload headroom
                    stats["queue_depth"] = batcher.q.qsize()
                    stats["queue_capacity"] = batcher.q.maxsize
                self._send(200, json.dumps(stats).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):  # noqa: N802
            if self.path != "/sr":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0 or n > max_body_bytes:
                # refused before reading: an oversized upload never lands in
                # host memory, and a garbage length never becomes a read that
                # waits for the client to close
                self._count("rejected_oversize")
                self._send(413, f"body length {n} outside [0, {max_body_bytes}]".encode(), "text/plain")
                return
            img = cv2.imdecode(np.frombuffer(self.rfile.read(n), np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                self._count("failed")
                self._send(400, b"undecodable image", "text/plain")
                return
            t0 = time.perf_counter()
            rgb = np.asarray(img[..., ::-1], np.float32) / 255.0
            try:
                sr = batcher.submit(rgb) if batcher is not None else engine.sr_array(rgb)
            except OverloadedError as e:
                self._count("rejected")
                self._send(503, str(e).encode(), "text/plain", extra_headers={"Retry-After": "1"})
                return
            except Exception as e:  # noqa: BLE001 - an engine error answers 500
                self._count("failed")
                self._send(500, f"{type(e).__name__}: {e}".encode()[:1000], "text/plain")
                return
            sr8 = np.clip(sr * 255.0, 0, 255).astype(np.uint8)
            ok, buf = cv2.imencode(".png", sr8[..., ::-1])
            if not ok:
                self._count("failed")
                self._send(500, b"encode failed", "text/plain")
                return
            with stats_lock:
                engine.served += 1
                engine.latencies_ms.append((time.perf_counter() - t0) * 1e3)
            self._send(200, buf.tobytes(), "image/png")

    base = http.server.ThreadingHTTPServer if batcher is not None else http.server.HTTPServer

    class Server(base):
        # the listen backlog: socketserver's 5 resets the connections of a
        # burst before the bounded queue could answer them with 503
        request_queue_size = 128

    if batcher is None:
        engine.use_device()  # this thread runs the model
    try:
        with Server((host, port), Handler) as srv:
            bound = srv.server_address[:2]
            mode = "micro-batched" if batcher is not None else "single-threaded"
            print(f"serving on http://{bound[0]}:{bound[1]} (POST /sr, {mode})", file=sys.stderr, flush=True)
            if should_stop is not None:
                # the signal handler only sets a flag; this watcher turns it
                # into a shutdown: the request in hand finishes, then
                # serve_forever returns
                def watch():
                    while not should_stop():
                        time.sleep(0.2)
                    srv.shutdown()

                threading.Thread(target=watch, daemon=True).start()
            if ready is not None:
                ready(bound)
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
    finally:
        if batcher is not None:
            batcher.close()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="srganfd_tpu_torch serving daemon")
    ap.add_argument("--model-arch", dest="arch", default="rrdbnet_x4")
    ap.add_argument("--weights", default="",
                    help=".pth (tools/export_to_torch.py) or .npz of the Flax tree")
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--device-type", dest="device", default="cuda", choices=["cuda", "cpu"])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--stdio", action="store_true", help="JSONL on stdin/stdout")
    mode.add_argument("--watch", default="", help="poll this dir for frames")
    mode.add_argument("--port", type=int, default=0, help="HTTP server port")
    ap.add_argument("--output", default="", help="output dir (watch mode)")
    ap.add_argument("--once", action="store_true", help="watch: drain backlog and exit")
    ap.add_argument("--poll-interval", type=float, default=0.5)
    ap.add_argument("--bucket", type=int, default=0,
                    help="pad inputs to multiples of this; 0 = exact shapes")
    ap.add_argument("--batch", default="1", type=_batch_arg,
                    help="watch mode: drain backlogs in calls of this many frames "
                    "(same-shape frames stack into one forward; tails repeat-pad); "
                    "'auto' = the drain ladder (16s, then one 8, then singles). HTTP "
                    "mode: 'auto' also threads the server and micro-batches concurrent "
                    "requests (a fixed N leaves HTTP one frame a forward)")
    ap.add_argument("--warmup", default="", help="run these shapes first, e.g. 256x256,512x512")
    ap.add_argument("--half", action="store_true", help="bfloat16 compute")
    ap.add_argument("--self-ensemble", action="store_true")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--tile-overlap", type=int, default=16)
    ap.add_argument("--max-body-mb", type=int, default=64,
                    help="HTTP: reject POST bodies larger than this with 413")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="HTTP --batch auto: bound the micro-batcher queue; "
                    "overflow requests get 503 + Retry-After")
    add_attention_flags(ap)
    add_quant_flag(ap)
    add_parallel_flags(ap)
    args = ap.parse_args(argv)
    if args.watch and not args.output:
        ap.error("--watch requires --output")

    engine = ServingEngine(
        args.arch, weights=args.weights, use_ema=args.use_ema, half=args.half,
        quant_int8=args.quant_int8, self_ensemble=args.self_ensemble, tile=args.tile, tile_overlap=args.tile_overlap,
        bucket=args.bucket, batch=args.batch, attn_chunk=args.attn_chunk,
        attn_backend=args.attn_backend, device=args.device, spatial_shard=args.spatial_shard,
        cp_backend=args.cp_backend,
    )

    # graceful drain: SIGTERM finishes the in-flight frame, then the loop
    # exits and final stats land on stderr. Under --spatial-shard a rank
    # other than 0 sends its request to rank 0 with the next frame, and
    # rank 0's stop releases every rank
    stop = {"flag": False}

    def _stop(signum, frame):  # pragma: no cover - signal path
        stop["flag"] = engine.stop_flag = True
        print(f"signal {signum}: draining", file=sys.stderr, flush=True)

    import signal as _signal

    try:
        _signal.signal(_signal.SIGTERM, _stop)
    except ValueError:  # not the main thread
        pass

    if engine.spatial and engine.rank != 0:  # rank 0 owns the transport
        engine.follow()
        return
    should_stop = lambda: stop["flag"] or engine.peer_stop  # noqa: E731
    try:
        if args.warmup:
            shapes = [tuple(int(v) for v in s.split("x")) for s in args.warmup.split(",")]
            engine.warmup(shapes)
        if args.stdio:
            serve_stdio(engine, should_stop=lambda: engine.peer_stop)
        elif args.watch:
            serve_watch(
                engine, args.watch, args.output, poll_s=args.poll_interval,
                once=args.once, should_stop=should_stop,
            )
        else:
            serve_http(
                engine, args.port,
                max_body_bytes=args.max_body_mb * 1024 * 1024,
                max_queue=args.max_queue,
                should_stop=should_stop,
            )
    finally:
        engine.close()
        print(json.dumps({"final_stats": engine.stats()}), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
