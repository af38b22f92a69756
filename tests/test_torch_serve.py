"""The port's serving daemon and inference CLI against the JAX package's,
on the same tiny weights (16 channels, growth 8, 2 RRDBs; drawn so that
the outputs spread over [0, 1]) and the same frames, on the CPU. Output
PNGs may differ by one level: the two frameworks sum the convs in
different orders."""

import functools
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import srganfd_tpu.models
from srganfd_tpu.cli import infer as jax_infer
from srganfd_tpu.cli import serve as jax_serve
from srganfd_tpu.models import blocks as jax_blocks
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu_torch.cli import infer as port_infer
from srganfd_tpu_torch.cli import serve as port_serve
from srganfd_tpu_torch.convert import flax_to_state_dict
from srganfd_tpu_torch.models import create_model as create_port
from test_torch_generator import tiny_kwargs, tiny_params
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ARCH = "bsrgan_x2"
TINY = tiny_kwargs(ARCH)


class _FixedInit:
    """A JAX model whose ``init`` returns the tiny test params: the JAX
    CLIs without ``--weights`` serve what ``init`` gives."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kwargs):
        return {"params": tiny_params(ARCH)}

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


def _fixed_init_model(arch, **kwargs):
    return _FixedInit(create_flax(arch, **{**TINY, **kwargs}))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "g.pth"
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(tiny_params(ARCH)).items()}
    torch.save({"state_dict": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def engines(weights):
    # without --weights the JAX daemon serves what ``init`` gives
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srganfd_tpu.models, "create_model", _fixed_init_model)
        jax_engine = jax_serve.ServingEngine(ARCH, model_kwargs=TINY)
    port_engine = port_serve.ServingEngine(ARCH, weights=weights, model_kwargs=TINY, device="cpu")
    return jax_engine, port_engine


def _write_png(path, h, w, seed):
    img = (np.random.default_rng(seed).uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(path), img)


def _assert_pngs_close(a, b):
    ia, ib = cv2.imread(str(a)), cv2.imread(str(b))
    assert ia is not None and ib is not None and ia.shape == ib.shape
    assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 1, (a, b)


def _stdio(engine, tmp_path, tag, frames):
    reqs = [{"id": i, "input": str(f), "output": str(tmp_path / tag / f.name)}
            for i, f in enumerate(frames)]
    lines = [json.dumps(r) for r in reqs] + ['{"cmd": "stats"}', '{"cmd": "shutdown"}']
    out = io.StringIO()
    (jax_serve if tag == "jax" else port_serve).serve_stdio(
        engine, inp=io.StringIO("\n".join(lines)), out=out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _strip(reply, root):
    drop = {"ms", "p50_ms", "p95_ms"}
    out = {k: v for k, v in reply.items() if k not in drop}
    if "output" in out:
        out["output"] = os.path.basename(out["output"])
    if "compiled_shapes" in out:
        out["compiled_shapes"] = [list(s) for s in out["compiled_shapes"]]
    return out


def test_stdio_replies_and_outputs_match_jax(engines, tmp_path):
    jax_engine, port_engine = engines
    frames = [tmp_path / "f0.png", tmp_path / "f1.png"]
    _write_png(frames[0], 20, 24, 0)
    _write_png(frames[1], 17, 13, 1)
    got = _stdio(port_engine, tmp_path, "port", frames)
    want = _stdio(jax_engine, tmp_path, "jax", frames)
    assert len(got) == len(want) == 3
    assert [_strip(r, tmp_path) for r in got] == [_strip(r, tmp_path) for r in want]
    assert got[0]["ok"] and got[0]["out_hw"] == [40, 48] and got[1]["out_hw"] == [34, 26]
    for f in frames:
        _assert_pngs_close(tmp_path / "port" / f.name, tmp_path / "jax" / f.name)


@pytest.mark.parametrize("config", [
    {"bucket": 16},
    {"batch": 2},
    {"tile": 16, "tile_overlap": 4},
    {"self_ensemble": True},
], ids=["bucket", "batch2", "tile", "self_ensemble"])
def test_serving_modes_match_jax(engines, tmp_path, config):
    """Each mode drains the same 3-frame backlog through the watch
    transport (``--batch 2`` leaves a ragged tail of one)."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i, (h, w) in enumerate([(20, 24), (20, 24), (18, 30)]):
        _write_png(in_dir / f"f{i}.png", h, w, 10 + i)
    for engine, mod, tag in ((engines[0], jax_serve, "jax"), (engines[1], port_serve, "port")):
        saved = {k: getattr(engine, k) for k in config}
        for k, v in config.items():
            setattr(engine, k, v)
        try:
            assert mod.serve_watch(engine, str(in_dir), str(tmp_path / tag), once=True) == 3
        finally:
            for k, v in saved.items():
                setattr(engine, k, v)
    assert sorted(os.listdir(tmp_path / "port")) == ["f0.png", "f1.png", "f2.png"]
    for name in os.listdir(tmp_path / "jax"):
        _assert_pngs_close(tmp_path / "port" / name, tmp_path / "jax" / name)


@pytest.fixture
def tiny_clis(monkeypatch):
    """Both CLIs build the tiny model with the same params (the port
    loads them from ``weights``)."""
    monkeypatch.setattr(jax_infer, "create_model", _fixed_init_model)
    monkeypatch.setattr(port_infer, "create_model", functools.partial(create_port, **TINY))


def _run(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["infer", *argv])
    main()


def test_infer_single_image_matches_jax(tiny_clis, weights, tmp_path, monkeypatch):
    _write_png(tmp_path / "in.png", 14, 18, 20)
    common = ["--model-arch", ARCH, "--inputs-path", str(tmp_path / "in.png"), "--device-type", "cpu"]
    _run(jax_infer.main, [*common, "--output-path", str(tmp_path / "jax.png")], monkeypatch)
    port_infer.main([*common, "--output-path", str(tmp_path / "port.png"), "--weights", weights])
    _assert_pngs_close(tmp_path / "port.png", tmp_path / "jax.png")
    assert cv2.imread(str(tmp_path / "port.png")).shape == (28, 36, 3)


def test_infer_sequence_matches_jax(tiny_clis, weights, tmp_path, monkeypatch):
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):  # ragged tail at --batch 2
        _write_png(frames / f"a{i}.png", 12, 10, i)
    for i in range(2):  # a second shape bucket
        _write_png(frames / f"b{i}.png", 8, 8, 10 + i)
    common = ["--model-arch", ARCH, "--inputs-path", str(frames), "--batch", "2",
              "--device-type", "cpu"]
    _run(jax_infer.main, [*common, "--output-path", str(tmp_path / "jax")], monkeypatch)
    port_infer.main([*common, "--output-path", str(tmp_path / "port"), "--weights", weights])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == [
        "a0.png", "a1.png", "a2.png", "b0.png", "b1.png"]
    for name in names:
        _assert_pngs_close(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_cuda_without_gpu_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_png(tmp_path / "in.png", 8, 8, 0)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_infer.main(["--inputs-path", str(tmp_path / "in.png"),
                         "--output-path", str(tmp_path / "o.png")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_serve.main(["--stdio"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_serve.ServingEngine(ARCH, model_kwargs=TINY)
    assert not (tmp_path / "o.png").exists()


@pytest.mark.parametrize("argv", [
    ["serve", "--stdio", "--quant-int8"],
    ["serve", "--stdio", "--spatial-shard"],
    ["serve", "--stdio", "--cp-backend", "ulysses"],
    ["infer", "--inputs-path", "in.png", "--output-path", "o.png", "--data-shard"],
    ["serve", "--stdio", "--spatial-shard", "--tile", "64"],
], ids=lambda a: a[0] + (a[-1] if a[-1].startswith("--") else a[-2]))
def test_unported_flags_name_the_roadmap_item(argv, monkeypatch, tmp_path):
    """The JAX CLIs' flags are all ported: ``--quant-int8`` builds the
    quantized model, ``--spatial-shard``, ``--cp-backend`` and
    ``--data-shard`` run (a world of one without a process group), each
    daemon answering over stdio and the one-shot CLI writing its frame.
    What stays refused is refused as in JAX: ``--spatial-shard`` with
    ``--tile``."""
    main = port_serve.main if argv[0] == "serve" else port_infer.main
    seen = []
    real = port_infer.create_model
    monkeypatch.setattr(port_infer, "create_model",
                        lambda arch, **kw: seen.append(kw) or real(arch, **{**kw, **TINY}))
    monkeypatch.setattr(sys, "stdin", io.StringIO('{"cmd": "shutdown"}\n'))
    if "--tile" in argv:
        with pytest.raises(ValueError, match="mutually exclusive"):
            main(["--device-type", "cpu", "--model-arch", "bsrgan_x2", *argv[1:]])
        return
    if argv[0] == "infer":
        _write_png(tmp_path / "in.png", 8, 8, 0)
        argv = [a if a not in ("in.png", "o.png") else str(tmp_path / a) for a in argv]
    main(["--device-type", "cpu", "--model-arch", "bsrgan_x2", *argv[1:]])
    assert len(seen) == 1
    if "--quant-int8" in argv:
        assert seen[0]["quant"] is True
    if argv[0] == "infer":
        assert cv2.imread(str(tmp_path / "o.png")).shape == (16, 16, 3)


@pytest.mark.parametrize("what", ["model_axis", "pipe_axis", "dcn", "pipeline_microbatches"])
def test_unported_parallel_modes_name_the_roadmap_item(what):
    """Tensor and pipeline parallelism, the multi-slice mesh and the pipe
    axis's microbatches stay refused, naming ROADMAP.md A11, in the mesh
    and in the trainer that reads a config's mesh fields."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.parallel import mesh
    from srganfd_tpu_torch.train.loop import Trainer

    over = {"model_axis": {"mesh_shape": (1, -1), "mesh_axes": ("data", "model")},
            "pipe_axis": {"mesh_shape": (-1, 1), "mesh_axes": ("data", "pipe")},
            "dcn": {"dcn_mesh_shape": (1,)},
            "pipeline_microbatches": {"pipeline_microbatches": 2}}[what]
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A11"):
        Trainer(configs.get_config("bsrnet", g_kwargs={"channels": 8, "growth_channels": 4, "num_rrdb": 1}, **over))
    if "mesh_axes" in over:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A11"):
            mesh.make_mesh(over["mesh_shape"], over["mesh_axes"])
    if what == "dcn":
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A11"):
            mesh.make_hybrid_mesh((-1,), (1,))


@pytest.mark.parametrize("flags", [
    ["--attn-chunk", "64"],
    ["--attn-chunk", "64", "--attn-backend", "flash"],
], ids=["chunk", "chunk_flash"])
def test_attention_flags_on_bsrgan_x2_are_ignored_as_in_jax(
    flags, tiny_clis, weights, tmp_path, monkeypatch, capsys
):
    """bsrgan_x2 has no attention: both CLIs print the same notice and
    write the same frame as without the flags."""
    monkeypatch.setattr(jax_blocks, "_attention_backend", "chunked")  # the JAX CLI sets it
    _write_png(tmp_path / "in.png", 14, 18, 21)
    common = ["--model-arch", ARCH, "--inputs-path", str(tmp_path / "in.png"),
              "--device-type", "cpu", *flags]
    _run(jax_infer.main, [*common, "--output-path", str(tmp_path / "jax.png")], monkeypatch)
    jax_said = [line for line in capsys.readouterr().out.splitlines() if line.startswith("! --attn")]
    port_infer.main([*common, "--output-path", str(tmp_path / "port.png"), "--weights", weights])
    port_said = [line for line in capsys.readouterr().out.splitlines() if line.startswith("! --attn")]
    assert port_said == jax_said == ["! --attn-chunk ignored: arch 'bsrgan_x2' has no attention to chunk"]
    _assert_pngs_close(tmp_path / "port.png", tmp_path / "jax.png")


def test_serve_takes_attention_flags(tiny_clis, weights, tmp_path, monkeypatch, capsys):
    _write_png(tmp_path / "f.png", 10, 8, 22)
    req = json.dumps({"id": 7, "input": str(tmp_path / "f.png"), "output": str(tmp_path / "o.png")})
    monkeypatch.setattr(sys, "stdin", io.StringIO(req + "\n"))
    port_serve.main(["--model-arch", ARCH, "--weights", weights, "--device-type", "cpu", "--stdio",
                     "--attn-chunk", "64", "--attn-backend", "flash"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "! --attn-chunk ignored: arch 'bsrgan_x2' has no attention to chunk"
    reply = json.loads(out[1])
    assert reply["ok"] and reply["id"] == 7 and reply["out_hw"] == [20, 16]
