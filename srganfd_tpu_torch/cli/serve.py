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
  --port N           HTTP: not ported yet (ROADMAP.md A6).

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
  - ``--half`` serves in bfloat16; ``--self-ensemble`` and ``--tile``
    compose like the one-shot CLI.
  - request latency percentiles (p50/p95) are reported on shutdown and
    by ``{"cmd": "stats"}``.

Runs on ``cuda`` unless ``--device-type cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import cv2
import numpy as np
import torch

from srganfd_tpu_torch.cli.infer import (
    add_unported_flags,
    build_model,
    choice_device,
    make_apply,
    reject_unported,
)
from srganfd_tpu_torch.data.datasets import list_image_files, load_image_rgb

__all__ = ["ServingEngine", "serve_stdio", "serve_watch", "main"]


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
        self_ensemble: bool = False,
        tile: int = 0,
        tile_overlap: int = 16,
        bucket: int = 0,
        batch: int | str = 1,
        model_kwargs: dict | None = None,
        device: str = "cuda",
        seed: int = 0,
    ) -> None:
        self.device = choice_device(device)
        self.model = build_model(
            arch, self.device, weights, use_ema, half, model_kwargs=model_kwargs, seed=seed
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
        self.latencies_ms: list[float] = []
        self._shapes: set[tuple[int, int]] = set()
        self.stats_lock = threading.Lock()

    # -- core -------------------------------------------------------------
    def sr_array(self, img: np.ndarray) -> np.ndarray:
        """float32 HWC [0,1] -> SR HWC [0,1]; pads to the bucket, crops
        back to ``upscale * true_size``."""
        padded, h, w = _pad_to_multiple(img, self.bucket)
        with self.stats_lock:
            self._shapes.add(padded.shape[:2])
        if self.tile:
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
        per_frame = (self.batch != "auto" and self.batch <= 1) or self.tile or self.self_ensemble
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
            shapes = sorted(self._shapes)
        pick = lambda q: round(lat[min(len(lat) - 1, int(q * len(lat)))], 2) if lat else None
        return {
            "served": served,
            "failed": failed,
            "rejected": 0,  # HTTP overload counters: no HTTP transport yet
            "rejected_oversize": 0,
            "p50_ms": pick(0.50),
            "p95_ms": pick(0.95),
            # input shapes served (the JAX daemon's compiled-program count)
            "compiled_shapes": shapes,
            "upscale": self.upscale,
        }


# -- transports -----------------------------------------------------------


def serve_stdio(engine: ServingEngine, inp=None, out=None) -> None:
    """JSONL request/reply loop; injectable streams for tests."""
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    for line in inp:
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
    mode.add_argument("--port", type=int, default=0, help="HTTP server (not ported yet)")
    ap.add_argument("--output", default="", help="output dir (watch mode)")
    ap.add_argument("--once", action="store_true", help="watch: drain backlog and exit")
    ap.add_argument("--poll-interval", type=float, default=0.5)
    ap.add_argument("--bucket", type=int, default=0,
                    help="pad inputs to multiples of this; 0 = exact shapes")
    ap.add_argument("--batch", default="1", type=_batch_arg,
                    help="watch mode: drain backlogs in calls of this many frames "
                    "(same-shape frames stack into one forward; tails repeat-pad); "
                    "'auto' = the drain ladder (16s, then one 8, then singles)")
    ap.add_argument("--warmup", default="", help="run these shapes first, e.g. 256x256,512x512")
    ap.add_argument("--half", action="store_true", help="bfloat16 compute")
    ap.add_argument("--self-ensemble", action="store_true")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--tile-overlap", type=int, default=16)
    ap.add_argument("--max-body-mb", type=int, default=64, help="HTTP only (not ported yet)")
    ap.add_argument("--max-queue", type=int, default=32, help="HTTP only (not ported yet)")
    add_unported_flags(ap)
    args = ap.parse_args(argv)
    reject_unported(args)
    if args.watch and not args.output:
        ap.error("--watch requires --output")

    engine = ServingEngine(
        args.arch, weights=args.weights, use_ema=args.use_ema, half=args.half,
        self_ensemble=args.self_ensemble, tile=args.tile, tile_overlap=args.tile_overlap,
        bucket=args.bucket, batch=args.batch, device=args.device,
    )
    if args.warmup:
        shapes = [tuple(int(v) for v in s.split("x")) for s in args.warmup.split(",")]
        engine.warmup(shapes)

    # graceful drain: SIGTERM finishes the in-flight frame, then the loop
    # exits and final stats land on stderr
    stop = {"flag": False}

    def _stop(signum, frame):  # pragma: no cover - signal path
        stop["flag"] = True
        print(f"signal {signum}: draining", file=sys.stderr, flush=True)

    import signal as _signal

    try:
        _signal.signal(_signal.SIGTERM, _stop)
    except ValueError:  # not the main thread
        pass

    try:
        if args.stdio:
            serve_stdio(engine)
        else:
            serve_watch(
                engine, args.watch, args.output, poll_s=args.poll_interval,
                once=args.once, should_stop=lambda: stop["flag"],
            )
    finally:
        print(json.dumps({"final_stats": engine.stats()}), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
