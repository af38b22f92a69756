"""The port's Real-ESRGAN generators against the JAX package's: the NHWC
``pixel_unshuffle``, ``RealESRGANNet`` x4 and x2 on weights carried through
``convert.py``'s Real-ESRGAN mapping, the mapping's refusals, a JAX
checkpoint through ``load_generator_weights``, and ``realesrgan_x2``
serving and inference, odd frames included.

Tiny widths (16 channels, growth 8, 2 RRDBs); weights drawn with numpy
from a seed so that the outputs spread over [0, 1]."""

import functools
import io
import json
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srganfd_tpu.models
from srganfd_tpu.cli import infer as jax_infer
from srganfd_tpu.cli import serve as jax_serve
from srganfd_tpu.models import blocks as jax_blocks
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.models.blocks import stack_trunk_params
from srganfd_tpu_torch.cli import infer as port_infer
from srganfd_tpu_torch.cli import serve as port_serve
from srganfd_tpu_torch.convert import (
    flax_to_state_dict,
    load_generator_weights,
    realesrgan_flax_to_state_dict,
    state_dict_to_flax,
)
from srganfd_tpu_torch.models import blocks, create_model, list_models
from test_torch_generator import tiny_params
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ARCHS = ["realesrgan_x4", "realesrgan_x2"]
TINY = {"channels": 16, "growth_channels": 8, "num_rrdb": 2}


@functools.cache
def re_params(arch):
    """The tiny JAX model's param tree from ``eval_shape``, filled from a
    numpy seed as ``test_torch_generator.tiny_params`` fills it."""
    model = create_flax(arch, **TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.float32))
    rng = np.random.default_rng(1)

    def draw(s):
        if len(s.shape) == 4:  # HWIO kernel
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map(draw, dict(shapes["params"]))
    params["Conv_5"]["Conv_0"]["bias"] += 0.5
    return params


def _jax(arch, x, **kw):
    model = create_flax(arch, **TINY, **kw)
    return np.asarray(jax.jit(model.apply)({"params": re_params(arch)}, jnp.asarray(x)))


def _port(arch, dtype=torch.float32):
    model = create_model(arch, dtype=dtype, **TINY)
    model.load_state_dict({k: torch.tensor(v) for k, v in flax_to_state_dict(re_params(arch)).items()})
    return model.eval()


def _lr(seed, shape=(2, 12, 10, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# -- pixel_unshuffle ----------------------------------------------------------------


@pytest.mark.parametrize("factor", [2, 4])
def test_pixel_unshuffle_matches_jax(factor):
    """Exact, on every channel: a wrong (c, fh, fw) order moves values
    between channels, which conv1's 12 mixed input channels would show."""
    x = np.random.default_rng(factor).normal(size=(2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jax_blocks.pixel_unshuffle(jnp.asarray(x), factor))
    got = blocks.pixel_unshuffle(torch.from_numpy(x), factor).numpy()
    assert got.shape == (2, 8 // factor, 12 // factor, 3 * factor * factor)
    np.testing.assert_array_equal(got, want)


def test_pixel_unshuffle_refuses_an_odd_frame_and_names_the_bucket():
    with pytest.raises(ValueError, match="--bucket 2"):
        blocks.pixel_unshuffle(torch.zeros(1, 7, 8, 3), 2)


# -- the generator --------------------------------------------------------------------


def test_realesrgan_archs_are_registered():
    assert {"realesrgan_x4", "rrdbnet_realesrgan_x4", "realesrgan_x2"} <= set(list_models())
    assert create_model("realesrgan_x2", **TINY).upscale == 2
    assert create_model("rrdbnet_realesrgan_x4", **TINY).upscale == 4


@pytest.mark.parametrize("arch", [*ARCHS, "rrdbnet_realesrgan_x4"])
def test_realesrgan_matches_jax_f32(arch):
    """f32, the JAX model on the CPU: held to 1e-5 absolute."""
    tree_arch = "realesrgan_x4" if arch == "rrdbnet_realesrgan_x4" else arch
    x = _lr(0)
    want = _jax(tree_arch, x)
    model = create_model(arch, **TINY)
    model.load_state_dict({k: torch.tensor(v) for k, v in flax_to_state_dict(re_params(tree_arch)).items()})
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((2, 24, 20, 3) if arch == "realesrgan_x2" else (2, 48, 40, 3))
    assert 0.05 < want.mean() < 0.95, "outputs clamped flat: the comparison would see nothing"
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_realesrgan_matches_jax_bf16(arch):
    """bf16 against the JAX model in bf16 (``RealESRGANNet`` takes no
    ``pallas`` switch: its trunk is the XLA RDB). Held to 4 bf16 ulps at
    1.0 (2**-6), as the other generators are (``test_torch_generator.py``)."""
    x = _lr(1)
    want = _jax(arch, x, dtype=jnp.bfloat16)
    with torch.inference_mode():
        got = _port(arch, torch.bfloat16)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2**-6, rtol=0)


# -- the weight bridge ----------------------------------------------------------------------


@pytest.mark.parametrize("scan_blocks", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_realesrgan_round_trip_is_exact(arch, scan_blocks):
    params = re_params(arch)
    if scan_blocks:
        params = stack_trunk_params(params, 2)
    sd = realesrgan_flax_to_state_dict(params)
    model = create_model(arch, **TINY)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})  # strict
    back = state_dict_to_flax(model.state_dict(), num_blocks=2, scan_blocks=scan_blocks)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)


def test_dispatch_sends_an_unshuffled_conv1_to_the_realesrgan_mapping(monkeypatch):
    """An x2 tree (conv1 on 12 channels) goes through the Real-ESRGAN
    mapping; an x4 tree holds the RRDB map's leaves and names."""
    import srganfd_tpu_torch.convert as convert

    seen = []
    real = convert.realesrgan_flax_to_state_dict
    monkeypatch.setattr(convert, "realesrgan_flax_to_state_dict", lambda p: seen.append(1) or real(p))
    convert.flax_to_state_dict(re_params("realesrgan_x2"))
    assert seen == [1]
    assert set(convert.flax_to_state_dict(re_params("realesrgan_x4"))) == set(
        real(re_params("realesrgan_x4")))


@pytest.mark.parametrize("other", ["bsrgantrans_x2", "rrdbnet_x2", "rrdbnet_x8"])
def test_realesrgan_mapping_refuses_a_tree_of_another_layout(other):
    if other == "bsrgantrans_x2":
        model = create_flax(other, **TINY)
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(tree))
    else:
        tree = tiny_params(other)
    with pytest.raises(ValueError, match="RealESRGANNet"):
        realesrgan_flax_to_state_dict(tree)


def test_realesrgan_mapping_refuses_a_conv1_of_other_width():
    tree = jax.tree_util.tree_map(np.copy, re_params("realesrgan_x4"))
    tree["Conv_0"]["Conv_0"]["kernel"] = np.zeros((3, 3, 5, 16), np.float32)
    with pytest.raises(ValueError, match="conv1 takes"):
        realesrgan_flax_to_state_dict(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_generator_weights_takes_a_jax_realesrgan_checkpoint(tmp_path, arch):
    """A ``.npz`` of a JAX training state (``g_params``/``ema_g_params``,
    '/'-joined paths): the tree ``use_ema`` picks, mapped, loads strictly
    into the port's model."""
    g = re_params(arch)
    ema = jax.tree_util.tree_map(lambda v: v * 0.5, g)
    flat = {}
    for key, tree in (("g_params", g), ("ema_g_params", ema)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([key, *(p.key for p in path)])] = np.asarray(leaf)
    np.savez(tmp_path / "state.npz", **flat)
    for use_ema in (False, True):
        sd = load_generator_weights(str(tmp_path / "state.npz"), use_ema=use_ema)
        want = flax_to_state_dict(ema if use_ema else g)
        assert set(sd) == set(want)
        for k in want:
            np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
        create_model(arch, **TINY).load_state_dict(sd)


# -- serving and inference --------------------------------------------------------------------


class _FixedInit:
    """A JAX model whose ``init`` returns the tiny test params."""

    def __init__(self, model, arch):
        self.model, self.arch = model, arch

    def init(self, *args, **kwargs):
        return {"params": re_params(self.arch)}

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


def _fixed(arch, **kwargs):
    return _FixedInit(create_flax(arch, **{**TINY, **kwargs}), arch)


@pytest.fixture(scope="module")
def x2_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "x2.pth"
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in flax_to_state_dict(re_params("realesrgan_x2")).items()}},
               path)
    return str(path)


def _stdio(module, engine, requests):
    lines = [json.dumps(r) for r in requests] + ['{"cmd": "shutdown"}']
    out = io.StringIO()
    module.serve_stdio(engine, inp=io.StringIO("\n".join(lines)), out=out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("bucket", [0, 2])
def test_realesrgan_x2_odd_frame_is_served_as_jax_serves_it(x2_weights, tmp_path, bucket):
    """An even frame and an odd one (13x11). Without a bucket both daemons
    reply ``ok: false`` to the odd frame (the unshuffle needs even sizes)
    and keep serving; with ``--bucket 2`` both reflect-pad it, SR it and
    crop to 2x the true size. Output PNGs within one 8-bit level."""
    for name, (h, w) in (("even", (12, 10)), ("odd", (13, 11))):
        img = (np.random.default_rng(h).uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"{name}.png"), img)
    replies = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srganfd_tpu.models, "create_model", _fixed)
        jax_engine = jax_serve.ServingEngine("realesrgan_x2", model_kwargs=TINY, bucket=bucket)
    port_engine = port_serve.ServingEngine("realesrgan_x2", weights=x2_weights, model_kwargs=TINY,
                                           bucket=bucket, device="cpu")
    for tag, module, engine in (("jax", jax_serve, jax_engine), ("port", port_serve, port_engine)):
        reqs = [{"id": n, "input": str(tmp_path / f"{n}.png"), "output": str(tmp_path / tag / f"{n}.png")}
                for n in ("even", "odd", "even")]
        replies[tag] = _stdio(module, engine, reqs)
    for tag in ("jax", "port"):
        assert [r["ok"] for r in replies[tag]] == [True, bool(bucket), True], replies[tag]
        assert replies[tag][0]["out_hw"] == [24, 20]
    if bucket:
        assert replies["port"][1]["out_hw"] == replies["jax"][1]["out_hw"] == [26, 22]
    else:
        assert "--bucket 2" in replies["port"][1]["error"]
    names = ["even"] + (["odd"] if bucket else [])
    for n in names:
        a, b = cv2.imread(str(tmp_path / "port" / f"{n}.png")), cv2.imread(str(tmp_path / "jax" / f"{n}.png"))
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1, n


def test_realesrgan_x4_infer_matches_jax(tmp_path, monkeypatch):
    """``cli.infer --model-arch realesrgan_x4`` on a 2-frame directory, the
    JAX CLI on the same weights: PNGs within one 8-bit level."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(2):
        cv2.imwrite(str(frames / f"f{i}.png"),
                    (np.random.default_rng(i).uniform(size=(9, 7, 3)) * 255).astype(np.uint8))
    weights = tmp_path / "x4.pth"
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in
                               flax_to_state_dict(re_params("realesrgan_x4")).items()}}, weights)
    common = ["--model-arch", "realesrgan_x4", "--inputs-path", str(frames), "--device-type", "cpu"]
    monkeypatch.setattr(jax_infer, "create_model", _fixed)
    monkeypatch.setattr(port_infer, "create_model", functools.partial(create_model, **TINY))
    monkeypatch.setattr(sys, "argv", ["infer", *common, "--output-path", str(tmp_path / "jax")])
    jax_infer.main()
    port_infer.main([*common, "--output-path", str(tmp_path / "port"), "--weights", str(weights)])
    for i in range(2):
        a = cv2.imread(str(tmp_path / "port" / f"f{i}.png"))
        b = cv2.imread(str(tmp_path / "jax" / f"f{i}.png"))
        assert a.shape == b.shape == (36, 28, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
