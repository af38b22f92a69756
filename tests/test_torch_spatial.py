"""Spatially sharded inference and the sharded CLIs of the port, on gloo CPU
ranks, against the JAX package's on meshes of as many virtual devices.

The ranks are subprocesses (``tests/torch_dist_worker.py``), each with a
timeout; the JAX side runs here. The generator is a tiny ``bsrgan_x2``
(16 channels, growth 8, 2 RRDBs) on weights drawn so that its outputs
spread over [0, 1] (``tests/test_torch_generator.py``), converted to the
port. Held:

- ``spatial_sharded_sr`` on 2 and 4 ranks against JAX's on 2 and 4
  devices at 1e-5, on a frame whose height splits over the ranks and on
  one whose height does not (the reflect padding); every rank holds the
  whole frame, and the one-process loop of the same shards
  (``spatial_sr_loop``) equals it bit for bit;
- ``cli.infer --data-shard`` on 2 ranks against JAX's ``run_sequence`` on
  a 2-device mesh, and ``cli.serve --stdio --spatial-shard`` on 2 ranks
  against JAX's ``ServingEngine`` sharding over 2 devices: the files to
  one 8-bit level, as ``tests/test_torch_serve_http.py`` holds replies; the
  ranks exit 0 after the shutdown;
- a sharded server idle for longer than its group's timeout still serves
  (rank 0's keep-alive headers).
"""

import functools
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import srganfd_tpu.models
from srganfd_tpu.cli import infer as jax_infer
from srganfd_tpu.cli import serve as jax_serve
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.parallel import make_mesh
from srganfd_tpu.parallel.spatial import spatial_sharded_sr as jax_spatial_sr
from srganfd_tpu_torch.convert import flax_to_state_dict
from test_torch_generator import tiny_kwargs, tiny_params
from test_torch_serve import _fixed_init_model, _write_png
from torch_dist_worker import run_ranks, start_ranks
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ARCH = "bsrgan_x2"
TINY = tiny_kwargs(ARCH)
HALO = 4
FRAMES = {"aligned": (40, 24), "unaligned": (37, 20)}
WORLDS = (2, 4)
SEQ = [(16, 20), (16, 20), (16, 20), (12, 14)]  # three frames of one shape (a ragged tail of 1), one other
SERVE = [(24, 20), (19, 22)]
IDLE_TIMEOUT_S = 6.0  # the idle server's group timeout
KEEPALIVE_S = 0.5  # its rank 0's keep-alive interval


def _image(name):
    h, w = FRAMES[name]
    return np.random.default_rng(len(name)).uniform(size=(h, w, 3)).astype(np.float32)


def _state():
    return {k: np.asarray(v) for k, v in flax_to_state_dict(tiny_params(ARCH)).items()}


def _jax_apply():
    model = create_flax(ARCH, **TINY)
    return jax.jit(lambda p, z: model.apply({"params": p}, z))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_files")
    seq = root / "seq"
    seq.mkdir()
    for i, (h, w) in enumerate(SEQ):
        _write_png(seq / f"f{i}.png", h, w, 10 + i)
    for i, (h, w) in enumerate(SERVE):
        _write_png(root / f"s{i}.png", h, w, 20 + i)
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(tiny_params(ARCH)).items()}
    torch.save({"state_dict": sd}, root / "g.pth")
    return root


def _cli_cases(root):
    reqs = [json.dumps({"id": i, "input": str(root / f"s{i}.png"), "output": str(root / "port_serve" / f"s{i}.png")})
            for i in range(len(SERVE))] + ['{"cmd": "shutdown"}']
    common = ["--device-type", "cpu", "--model-arch", ARCH, "--weights", str(root / "g.pth")]
    return [
        ("infer", "cli", {"module": "infer", "tiny": TINY, "argv": [
            *common, "--inputs-path", str(root / "seq"), "--output-path", str(root / "port_seq"),
            "--batch", "2", "--data-shard"]}),
        ("serve", "cli", {"module": "serve", "tiny": TINY, "stdin_lines": reqs, "argv": [
            *common, "--stdio", "--spatial-shard", "--tile-overlap", str(HALO)]}),
    ]


@pytest.fixture(scope="module")
def ranks(files, tmp_path_factory):
    out = {}
    for n in WORLDS:
        cases = [(name, "spatial", {"arch": ARCH, "kwargs": TINY, "state": _state(), "image": _image(name),
                                    "halo": HALO}) for name in FRAMES]
        if n == 2:
            cases += _cli_cases(files)
        out[n] = start_ranks(n, cases, tmp_path_factory.mktemp(f"spatial{n}"), timeout=200)
    return {n: handle.wait() for n, handle in out.items()}  # the launches run at once


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(FRAMES))
def test_spatial_sharded_sr_matches_jax(name, n, ranks):
    """Every rank's frame is JAX's ``spatial_sharded_sr`` on ``n`` devices
    to 1e-5, at 2 x the true height."""
    img = _image(name)
    want = jax_spatial_sr(_jax_apply(), tiny_params(ARCH), img, 2, make_mesh(devices=jax.devices()[:n]), halo=HALO)
    for r, res in enumerate(ranks[n]):
        got = res[name]
        assert "error" not in got, got
        assert got["sr"].shape == want.shape == (2 * img.shape[0], 2 * img.shape[1], 3)
        np.testing.assert_allclose(got["sr"], want, atol=1e-5, rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(FRAMES))
def test_the_one_process_loop_is_the_sharded_run_bit_for_bit(name, n, ranks):
    """``spatial_sr_loop`` (each shard's halos from the padded frame, the
    forward, the crop) equals the collective run on rank 0, and every rank
    holds the same frame."""
    res = [r[name] for r in ranks[n]]
    assert np.array_equal(res[0]["loop"], res[0]["sr"])
    assert all(np.array_equal(r["sr"], res[0]["sr"]) for r in res)


def _levels(a, b) -> int:
    ia, ib = cv2.imread(str(a)), cv2.imread(str(b))
    assert ia is not None and ib is not None and ia.shape == ib.shape, (a, b)
    return int(np.abs(ia.astype(int) - ib.astype(int)).max())


def test_infer_data_shard_writes_the_jax_frames(ranks, files, tmp_path):
    """The two ranks together write every frame once (the ragged tail's
    pad not at all), each within one level of JAX's ``run_sequence`` with
    the batch sharded over 2 devices."""
    assert all("error" not in r["infer"] for r in ranks[2]), [r["infer"] for r in ranks[2]]
    paths = sorted(str(p) for p in (files / "seq").iterdir())
    jax_infer.run_sequence(_jax_apply(), tiny_params(ARCH), paths, str(tmp_path / "jax"), batch=2,
                           mesh=make_mesh(devices=jax.devices()[:2]))
    assert sorted(os.listdir(files / "port_seq")) == sorted(os.listdir(tmp_path / "jax")) == [
        f"f{i}.png" for i in range(len(SEQ))]
    for name in os.listdir(tmp_path / "jax"):
        assert _levels(files / "port_seq" / name, tmp_path / "jax" / name) <= 1, name
    written = [r["infer"]["stdout"] for r in ranks[2]]
    assert all("SR'd" in w for w in written), written


def test_serve_spatial_shard_replies_as_jax(ranks, files, tmp_path):
    """Rank 0 answers every request (the others print nothing), each frame
    within one level of JAX's ``ServingEngine`` with ``--spatial-shard``
    over 2 devices; the shutdown ends both ranks."""
    replies = [json.loads(line) for line in ranks[2][0]["serve"]["stdout"].splitlines()]
    assert ranks[2][1]["serve"]["stdout"] == ""
    assert [r["id"] for r in replies] == list(range(len(SERVE))) and all(r["ok"] for r in replies)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srganfd_tpu.models, "create_model", _fixed_init_model)
        engine = jax_serve.ServingEngine(ARCH, model_kwargs=TINY, spatial_shard=True, tile_overlap=HALO)
    engine.spatial_mesh = make_mesh(devices=jax.devices()[:2])
    for i, (h, w) in enumerate(SERVE):
        assert replies[i]["out_hw"] == [2 * h, 2 * w]
        engine.sr_file(str(files / f"s{i}.png"), str(tmp_path / f"s{i}.png"))
        assert _levels(files / "port_serve" / f"s{i}.png", tmp_path / f"s{i}.png") <= 1


def test_an_idle_sharded_server_outlives_the_group_timeout(ranks, files, tmp_path):
    """``cli.serve --stdio --spatial-shard`` on 2 ranks whose group times a
    collective out after IDLE_TIMEOUT_S: the client waits 1.5 times that
    before its one request, while rank 1 waits for the frame in a
    collective. Rank 0's keep-alive headers (every KEEPALIVE_S) keep the
    ranks in step: the frame is served, equal to the one served back to
    back, and the shutdown ends both ranks."""
    req = json.dumps({"id": 0, "input": str(files / "s0.png"), "output": str(tmp_path / "s0.png")})
    argv = ["--device-type", "cpu", "--model-arch", ARCH, "--weights", str(files / "g.pth"), "--stdio",
            "--spatial-shard", "--tile-overlap", str(HALO)]
    case = ("serve", "cli", {"module": "serve", "tiny": TINY, "argv": argv, "idle_s": 1.5 * IDLE_TIMEOUT_S,
                             "keepalive_s": KEEPALIVE_S, "stdin_lines": [req, '{"cmd": "shutdown"}']})
    got = run_ranks(2, [case], tmp_path, timeout=120, group_timeout=IDLE_TIMEOUT_S)
    assert all("error" not in r["serve"] for r in got), [r["serve"].get("error") for r in got]
    replies = [json.loads(line) for line in got[0]["serve"]["stdout"].splitlines()]
    assert [(r["id"], r["ok"]) for r in replies] == [(0, True)] and got[1]["serve"]["stdout"] == ""
    assert np.array_equal(cv2.imread(str(tmp_path / "s0.png")), cv2.imread(str(files / "port_serve" / "s0.png")))


def test_spatial_shard_with_tile_is_refused_as_in_jax():
    """``--spatial-shard`` and ``--tile`` are exclusive in the port's engine
    as in JAX's."""
    from srganfd_tpu_torch.cli import serve as port_serve

    with pytest.raises(ValueError, match="mutually exclusive"):
        port_serve.ServingEngine(ARCH, model_kwargs=TINY, device="cpu", spatial_shard=True, tile=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srganfd_tpu.models, "create_model", functools.partial(create_flax, **TINY))
        with pytest.raises(ValueError, match="mutually exclusive"):
            jax_serve.ServingEngine(ARCH, spatial_shard=True, tile=16)


def test_one_rank_without_a_group_is_the_loop_of_one_shard():
    """Without a process group ``--spatial-shard`` is a world of one: the
    frame with reflected halos, JAX's one-device mesh."""
    from srganfd_tpu_torch.models import create_model
    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.parallel.spatial import spatial_sharded_sr, spatial_sr_loop

    assert comm.world() == 1
    model = create_model(ARCH, **TINY)
    model.load_state_dict({k: torch.tensor(v) for k, v in _state().items()})
    model.eval()
    img = _image("unaligned")
    got = spatial_sharded_sr(model, img, 2, halo=HALO)
    assert np.array_equal(got, spatial_sr_loop(model, img, 2, 1, halo=HALO))
    want = jax_spatial_sr(_jax_apply(), tiny_params(ARCH), img, 2, make_mesh(devices=jax.devices()[:1]), halo=HALO)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
