"""The port's HTTP transport (``cli.serve --port``) and its micro-batcher,
mirroring ``tests/test_cli_serve.py``'s HTTP tests, with each reply's SR
held to the JAX ``ServingEngine``'s ``sr_array`` of the same frame on the
same weights (tiny ``bsrgan_x2``: 16 channels, growth 8, 2 RRDBs, drawn so
that the outputs spread over [0, 1]), on the CPU.

Tolerance: one 8-bit level after PNG, as the stdio transport's tests hold
it (the frameworks sum the convs in other orders, so a value near a level's
edge may round either way). Sockets bind port 0 and every client call has a
timeout, so no test can hang.
"""

import http.client
import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

import srganfd_tpu.models
from srganfd_tpu.cli import serve as jax_serve
from srganfd_tpu_torch.cli import serve as port_serve
from srganfd_tpu_torch.cli.serve import OverloadedError, ServingEngine, _MicroBatcher, serve_http
from srganfd_tpu_torch.convert import flax_to_state_dict
from test_torch_generator import tiny_kwargs, tiny_params
from test_torch_serve import ARCH, _fixed_init_model
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY = tiny_kwargs(ARCH)
TIMEOUT = 60


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "g.pth"
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(tiny_params(ARCH)).items()}
    torch.save({"state_dict": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def jax_engine():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srganfd_tpu.models, "create_model", _fixed_init_model)
        return jax_serve.ServingEngine(ARCH, model_kwargs=TINY)


def _engine(weights, **kw) -> ServingEngine:
    return ServingEngine(ARCH, weights=weights, model_kwargs=TINY, device="cpu", **kw)


def _frame(seed, h=14, w=18) -> np.ndarray:
    """A BGR uint8 frame, as cv2 reads it."""
    return (np.random.default_rng(seed).uniform(size=(h, w, 3)) * 255).astype(np.uint8)


def _png(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _serve(engine, **kw):
    """``serve_http`` on a free port in a daemon thread; returns (port,
    thread, stop) where ``stop()`` makes ``should_stop`` true."""
    bound, flag = {}, threading.Event()
    up = threading.Event()

    def ready(addr):
        bound["port"] = addr[1]
        up.set()

    th = threading.Thread(target=serve_http, args=(engine, 0),
                          kwargs={"should_stop": flag.is_set, "ready": ready, **kw}, daemon=True)
    th.start()
    assert up.wait(TIMEOUT), "server did not come up"
    return bound["port"], th, flag.set


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return r.status, r.read()


def _post(port, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/sr", body=body)
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _assert_within_a_level_of_jax(jax_engine, reply: bytes, frame_bgr: np.ndarray) -> None:
    """The reply's PNG against the JAX engine's ``sr_array`` of the same
    frame, quantised as the server quantises: at most one 8-bit level."""
    got = cv2.imdecode(np.frombuffer(reply, np.uint8), cv2.IMREAD_COLOR)
    want = jax_engine.sr_array(np.asarray(frame_bgr[..., ::-1], np.float32) / 255.0)
    want8 = np.clip(np.asarray(want) * 255.0, 0, 255).astype(np.uint8)[..., ::-1]
    assert got is not None and got.shape == want8.shape == (2 * frame_bgr.shape[0], 2 * frame_bgr.shape[1], 3)
    assert np.abs(got.astype(int) - want8.astype(int)).max() <= 1


def _stop(th, stop):
    stop()
    th.join(TIMEOUT)
    assert not th.is_alive()


def test_http_transport(weights, jax_engine):
    """Single-threaded (``--batch 1``): /healthz, POST /sr within a level of
    JAX, 404 elsewhere, 400 for an undecodable body (counted as failed),
    /stats without the queue fields."""
    eng = _engine(weights)
    port, th, stop = _serve(eng)
    assert _get(port, "/healthz") == (200, b"ok")
    img = _frame(0)
    status, body, headers = _post(port, _png(img))
    assert status == 200 and headers["Content-Type"] == "image/png"
    _assert_within_a_level_of_jax(jax_engine, body, img)
    status, body, _ = _post(port, b"not an image")
    assert (status, body) == (400, b"undecodable image")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404
    stats = json.loads(_get(port, "/stats")[1])
    assert (stats["served"], stats["failed"], stats["upscale"]) == (1, 1, 2)
    assert len(eng.latencies_ms) == 1 and "queue_depth" not in stats
    _stop(th, stop)


def test_http_micro_batching_concurrent_requests(weights, jax_engine):
    """``--batch auto``: 9 concurrent requests of 9 different frames. The
    first holds the dispatcher until the other 8 are queued, so they go
    through in one forward of 8 (the auto ladder): 2 forwards for 9
    requests. Each reply is its own frame's SR, within a level of JAX."""
    eng = _engine(weights, batch="auto")
    forwards = []
    apply, entered, release = eng._apply, threading.Event(), threading.Event()

    def gated(batch):
        forwards.append(len(batch))
        entered.set()
        assert release.wait(TIMEOUT)
        return apply(batch)

    eng._apply = gated
    port, th, stop = _serve(eng)
    frames = [_frame(10 + i) for i in range(9)]
    results = [None] * 9

    def post(i):
        results[i] = _post(port, _png(frames[i]))

    clients = [threading.Thread(target=post, args=(i,)) for i in range(9)]
    clients[0].start()
    assert entered.wait(TIMEOUT)
    for c in clients[1:]:
        c.start()
    for _ in range(int(TIMEOUT / 0.02)):
        if json.loads(_get(port, "/stats")[1])["queue_depth"] == 8:
            break
        time.sleep(0.02)
    release.set()
    for c in clients:
        c.join(TIMEOUT)
    assert [r[0] for r in results] == [200] * 9
    for (_, body, _), img in zip(results, frames):
        _assert_within_a_level_of_jax(jax_engine, body, img)
    assert forwards == [1, 8]
    stats = json.loads(_get(port, "/stats")[1])
    assert stats["served"] == 9 and stats["queue_capacity"] == 32 and stats["queue_depth"] == 0
    _stop(th, stop)


def test_http_burst_beyond_the_listen_backlog(weights):
    """24 clients connect at once (``--batch auto``): every one is answered
    200. The server listens with a backlog of 128; socketserver's default
    of 5 reset such a burst's connections while a forward held the host."""
    eng = _engine(weights, batch="auto")
    port, th, stop = _serve(eng)
    body, go = _png(_frame(4)), threading.Event()
    statuses = [None] * 24

    def post(i):
        go.wait()
        statuses[i] = _post(port, body)[0]

    clients = [threading.Thread(target=post, args=(i,)) for i in range(24)]
    for c in clients:
        c.start()
    go.set()
    for c in clients:
        c.join(TIMEOUT)
    assert statuses == [200] * 24 and eng.stats()["served"] == 24
    _stop(th, stop)


@pytest.mark.parametrize("batch", [1, "auto"])
def test_http_should_stop_drains_server(weights, batch):
    """``should_stop`` (the SIGTERM flag) shuts the server down and the
    serving thread ends; with ``--batch auto`` the dispatcher ends too."""
    def dispatchers():
        return sum(t.name == "sr-dispatch" and t.is_alive() for t in threading.enumerate())

    eng = _engine(weights, batch=batch)
    before = dispatchers()
    port, th, stop = _serve(eng)
    assert _get(port, "/healthz") == (200, b"ok")
    assert dispatchers() == before + (batch == "auto")
    _stop(th, stop)
    with pytest.raises(OSError):
        _get(port, "/healthz")
    assert dispatchers() == before


class _StuckEngine:
    """An engine whose ``sr_batch`` blocks until released."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def use_device(self):
        pass

    def sr_batch(self, imgs):
        self.entered.set()
        assert self.release.wait(TIMEOUT)
        return [im * 2 for im in imgs]


def test_micro_batcher_bounded_queue_rejects_when_full():
    """With the dispatcher stuck in a forward and the queue (2) full, a
    new submit fails at once with ``OverloadedError``; the queued ones are
    served after the release."""
    eng = _StuckEngine()
    mb = _MicroBatcher(eng, max_queue=2)
    frame = np.ones((4, 4, 3), np.float32)
    outs = {}
    waiters = [threading.Thread(target=lambda i=i: outs.update({i: mb.submit(frame)})) for i in range(3)]
    waiters[0].start()
    assert eng.entered.wait(TIMEOUT)
    for w in waiters[1:]:
        w.start()
    for _ in range(int(TIMEOUT / 0.02)):
        if mb.q.full():
            break
        time.sleep(0.02)
    assert mb.q.full()
    with pytest.raises(OverloadedError, match="queue full"):
        mb.submit(frame)
    eng.release.set()
    for w in waiters:
        w.join(TIMEOUT)
    assert sorted(outs) == [0, 1, 2] and all(np.array_equal(o, frame * 2) for o in outs.values())
    mb.close()


def test_micro_batcher_close_serves_what_is_queued():
    """``close`` (the SIGTERM drain) while a forward runs and two frames wait:
    all three are served, and a frame submitted after it is refused."""
    eng = _StuckEngine()
    mb = _MicroBatcher(eng, max_queue=4)
    frame = np.ones((4, 4, 3), np.float32)
    outs = {}
    waiters = [threading.Thread(target=lambda i=i: outs.update({i: mb.submit(frame)})) for i in range(3)]
    waiters[0].start()
    assert eng.entered.wait(TIMEOUT)
    for w in waiters[1:]:
        w.start()
    for _ in range(int(TIMEOUT / 0.02)):
        if mb.q.qsize() == 2:
            break
        time.sleep(0.02)
    closer = threading.Thread(target=mb.close)
    closer.start()
    for _ in range(int(TIMEOUT / 0.02)):
        if mb._closed.is_set():
            break
        time.sleep(0.02)
    with pytest.raises(OverloadedError, match="shutting down"):
        mb.submit(frame)
    eng.release.set()
    for t in (*waiters, closer):
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert sorted(outs) == [0, 1, 2] and not mb._thread.is_alive()


def test_http_overload_503_and_body_cap(weights, jax_engine):
    """An oversized body and a negative ``Content-Length`` get 413 before
    any read (``rejected_oversize``); with the dispatcher held and the
    queue at 2, a flood of 8 gets 3 answers and 5 503s with ``Retry-After:
    1`` (``rejected``); the served replies are within a level of JAX."""
    eng = _engine(weights, batch="auto")
    real, entered, release = eng.sr_batch, threading.Event(), threading.Event()

    def held(imgs):
        entered.set()
        assert release.wait(TIMEOUT)
        return real(imgs)

    eng.sr_batch = held
    port, th, stop = _serve(eng, max_body_bytes=64 * 1024, max_queue=2)
    status, body, _ = _post(port, b"\0" * (128 * 1024))
    assert status == 413 and b"outside [0, 65536]" in body
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
        s.sendall(b"POST /sr HTTP/1.1\r\nHost: x\r\nContent-Length: -1\r\n\r\n")
        assert b"413" in s.recv(64).split(b"\r\n", 1)[0]
    assert _get(port, "/healthz") == (200, b"ok")

    img = _frame(3)
    replies = [None] * 8

    def post(i):
        replies[i] = _post(port, _png(img))

    clients = [threading.Thread(target=post, args=(i,)) for i in range(8)]
    clients[0].start()
    assert entered.wait(TIMEOUT)
    for c in clients[1:]:
        c.start()
    for _ in range(int(TIMEOUT / 0.05)):
        if sum(r is not None and r[0] == 503 for r in replies) >= 5:
            break
        time.sleep(0.05)
    release.set()
    for c in clients:
        c.join(TIMEOUT)
    statuses = [r[0] for r in replies]
    assert statuses.count(200) == 3 and statuses.count(503) == 5, statuses
    assert all(r[2]["Retry-After"] == "1" for r in replies if r[0] == 503)
    for status, body, _ in replies:
        if status == 200:
            _assert_within_a_level_of_jax(jax_engine, body, img)
    stats = json.loads(_get(port, "/stats")[1])
    assert (stats["served"], stats["rejected"], stats["rejected_oversize"]) == (3, 5, 2)
    assert stats["queue_capacity"] == 2 and 0 <= stats["queue_depth"] <= 2
    _stop(th, stop)


@pytest.mark.parametrize("batch", [1, "auto"])
def test_http_engine_error_answers_500_to_every_waiter(weights, batch):
    """A failing forward answers 500, counted as failed; with ``--batch
    auto`` every request of the failed group gets it. Nothing retries."""
    eng = _engine(weights, batch=batch)

    def boom(_):
        raise RuntimeError("device lost")

    eng._apply = boom
    port, th, stop = _serve(eng)
    replies = [None] * 3

    def post(i):
        replies[i] = _post(port, _png(_frame(i)))

    clients = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(TIMEOUT)
    assert all(r[0] == 500 and b"device lost" in r[1] for r in replies), replies
    assert eng.stats()["failed"] == 3 and eng.stats()["served"] == 0
    _stop(th, stop)


def test_main_serves_http_with_the_overload_flags(monkeypatch):
    """``cli.serve --port`` is no longer refused: ``main`` hands the port,
    the body cap in bytes, the queue bound and the SIGTERM flag to
    ``serve_http``."""
    seen = {}

    def fake(engine, port, **kw):
        seen.update(engine=engine, port=port, **kw)

    monkeypatch.setattr(port_serve, "serve_http", fake)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        port_serve.main(["--device-type", "cpu", "--model-arch", ARCH, "--port", "8123", "--batch", "auto",
                         "--max-body-mb", "3", "--max-queue", "5"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert seen["port"] == 8123 and seen["engine"].batch == "auto"
    assert seen["max_body_bytes"] == 3 * 1024 * 1024 and seen["max_queue"] == 5
    assert seen["should_stop"]() is False
