"""A-ESRGAN's two generators in the port, ``gen_rrdb2x`` (``GeneratorRRDB``:
pixel-unshuffle front, RRDB trunk on ``rdb_apply``, no clamp) and
``gen_rpa2x`` (``GeneratorRPA``: pixel-attention blocks, no RDB, no clamp),
against the JAX package's Flax modules on the CPU: forwards in f32 and
bf16, parameter gradients against ``jax.grad``, the weight bridge both ways
and its refusals (``gen_rrdb2x``'s tree has a ``RealESRGANNet`` x2 tree's
very module names), ``cli.infer``, ``cli.serve --stdio`` and
``cli.test``'s ``g_arch`` override, and one ``Trainer`` step held to the
JAX ``Trainer``'s.

Tiny widths: 16 features, 2 blocks (growth 8 for the RDBs). Weights are
drawn from a numpy seed (kernels N(0, 1/fan_in), biases N(0, 0.1), 0.5 more
on the last conv's bias) so that the outputs spread over [0, 1].
"""

import argparse
import functools
import glob
import io
import json
import signal
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli import infer as port_infer
from srganfd_tpu_torch.cli import serve as port_serve
from srganfd_tpu_torch.cli import test as port_test
from srganfd_tpu_torch.convert import (
    flax_to_state_dict,
    gen_rpa_flax_to_state_dict,
    gen_rrdb_flax_to_state_dict,
    load_generator_weights,
    realesrgan_flax_to_state_dict,
    rrdb_flax_to_state_dict,
    state_dict_to_flax,
)
from srganfd_tpu_torch.models import arch_accepts, create_model
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY = {
    "gen_rrdb2x": {"num_feat": 16, "num_block": 2, "num_grow_ch": 8},
    "gen_rpa2x": {"num_feat": 16, "num_block": 2},
}
ARCHS = list(TINY)
LAST_CONV = {"gen_rrdb2x": "Conv_4", "gen_rpa2x": "Conv_2"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.cache
def _params(arch):
    model = create_flax(arch, **TINY[arch])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.float32))
    rng = np.random.default_rng(3)

    def draw(s):
        if len(s.shape) == 4:
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map(draw, dict(shapes["params"]))
    params[LAST_CONV[arch]]["Conv_0"]["bias"] += 0.5
    return params


@functools.cache
def _jax_fn(arch, dtype=jnp.float32):
    model = create_flax(arch, dtype=dtype, **TINY[arch])
    return jax.jit(lambda x: model.apply({"params": _params(arch)}, x))


def _port(arch, dtype=torch.float32):
    model = create_model(arch, dtype=dtype, **TINY[arch])
    model.load_state_dict({k: _t(v) for k, v in flax_to_state_dict(_params(arch)).items()})
    return model.eval()


def _lr(seed, shape=(2, 12, 10, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# -- forwards, gradients, init ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_matches_jax_f32(arch):
    x = _lr(0)
    want = np.asarray(_jax_fn(arch)(jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(arch)(_t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 24, 20, 3)
    assert want.min() < 0 or want.max() > 1  # no clamp in either
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_matches_jax_bf16(arch):
    """bf16 against the JAX f32 result, no further from it than 1.5x the
    JAX bf16 result is, or 2**-6 of its largest value (the frameworks round
    different sums: XLA adds a conv's bias in bf16, oneDNN before rounding;
    the JAX module runs the XLA RDB, the port its plain RDB)."""
    x = _lr(1)
    ref = np.asarray(_jax_fn(arch)(jnp.asarray(x)))
    jax_bf16 = np.asarray(_jax_fn(arch, jnp.bfloat16)(jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        got = _port(arch, torch.bfloat16)(_t(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= max(1.5 * _rel(jax_bf16, ref), 2.0**-6), (_rel(got.numpy(), ref),
                                                                              _rel(jax_bf16, ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_gradients_match_jax(arch):
    """Every parameter's gradient of a random projection of the output, f32,
    against ``jax.grad`` through the Flax module, to 1e-4 of each tensor's
    largest entry (sums of up to ~10^4 terms in other orders)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 8, 12, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    model = create_flax(arch, **TINY[arch])
    grads = jax.jit(jax.grad(lambda p: jnp.sum(model.apply({"params": p}, jnp.asarray(x)) * cot)))(_params(arch))
    want = flax_to_state_dict(grads)
    port = _port(arch).train()
    (port(_t(x)) * _t(cot)).sum().backward()
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert _rel(got[name], w) <= 1e-4, (name, _rel(got[name], w))


@pytest.mark.parametrize("arch", ARCHS)
def test_fresh_init_follows_the_jax_module(arch):
    """The registry builds both at full width (64 features; 23 RRDBs, 20 RPA
    blocks) with every parameter shape the JAX module's; the fresh init
    takes the kaiming x0.1 scale where the JAX module sets ``scaled_init``
    (the trunk; the RPA blocks' first three convs) and Flax's lecun-normal
    elsewhere: each conv's weight variance against the JAX init's, within
    sampling error, at full width and 2 blocks. Biases start at 0."""
    model = create_model(arch)
    blocks = model.body if arch == "gen_rrdb2x" else model.rpa
    assert len(blocks) == {"gen_rrdb2x": 23, "gen_rpa2x": 20}[arch] and model.upscale == 2
    assert arch_accepts(arch, "num_feat")
    jax_sd = flax_to_state_dict(jax.jit(create_flax(arch, num_block=2).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"])
    ours = create_model(arch, num_block=2, generator=torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in jax_sd.items()}
    assert set(ours) == set(jax_sd)
    for k, v in ours.items():
        if k.endswith(".bias"):
            assert not v.any(), k
        else:
            ratio = float(v.var()) / float(np.var(jax_sd[k]))
            assert 0.7 < ratio < 1.4, (k, ratio)


def test_gen_rrdb2x_runs_its_rdbs_through_rdb_apply(monkeypatch):
    """Every RDB of the trunk goes through ``rdb_apply`` (the RDB kernel on
    a CUDA tensor): 3 per RRDB; the RPA generator has none. An odd frame
    raises naming ``--bucket 2``."""
    from srganfd_tpu_torch.models import blocks

    calls = []
    real = blocks.rdb_apply
    monkeypatch.setattr(blocks, "rdb_apply", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        _port("gen_rrdb2x")(_t(_lr(2)))
        assert len(calls) == 3 * TINY["gen_rrdb2x"]["num_block"]
        _port("gen_rpa2x")(_t(_lr(2)))
        assert len(calls) == 3 * TINY["gen_rrdb2x"]["num_block"]
        with pytest.raises(ValueError, match="--bucket 2"):
            _port("gen_rrdb2x")(_t(_lr(2, (1, 11, 10, 3))))


# -- the bridge -----------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_and_reads_npz(arch, tmp_path):
    """Flax tree -> state dict -> Flax tree gives every leaf back, bit for
    bit; a ``.npz`` of the tree (a state's ``g_params`` too) loads through
    ``load_generator_weights`` into the model."""
    params = _params(arch)
    sd = flax_to_state_dict(params)
    back = state_dict_to_flax(sd, TINY[arch]["num_block"])
    assert _leaves(back).keys() == _leaves(params).keys()
    assert all(np.array_equal(_leaves(back)[k], v) for k, v in _leaves(params).items())
    flat = _leaves(params)
    np.savez(tmp_path / "g.npz", **flat)
    np.savez(tmp_path / "state.npz", **{f"g_params/{k}": v for k, v in flat.items()},
             **{f"ema_g_params/{k}": v * 2 for k, v in flat.items()})
    for path, scale, ema in (("g.npz", 1, False), ("state.npz", 2, True)):
        loaded = load_generator_weights(str(tmp_path / path), use_ema=ema)
        assert set(loaded) == set(sd)
        assert all(np.array_equal(loaded[k].numpy(), sd[k] * scale) for k in sd)
        create_model(arch, **TINY[arch]).load_state_dict(loaded)


def test_names_are_the_chosen_reference_ones():
    rrdb, rpa = (flax_to_state_dict(_params(a)) for a in ARCHS)
    assert {k.split(".")[0] for k in rrdb} == {"conv_first", "body", "conv_body", "conv_up1", "conv_up2",
                                               "conv_hr", "conv_last"}
    assert "body.1.rdb3.conv5.weight" in rrdb and rrdb["conv_last.weight"].shape == (3, 16, 3, 3)
    assert rrdb["conv_first.weight"].shape == (16, 12, 3, 3)
    assert {k.rsplit(".", 1)[0] for k in rpa if k.startswith(("rpa.1", "us.0"))} == {
        "rpa.1.conv1", "rpa.1.conv2", "rpa.1.conv3", "rpa.1.conv4", "us.0.conv1", "us.0.pa_conv", "us.0.conv2"}
    assert rpa["rpa.0.conv1.weight"].shape == (32, 16, 1, 1) and rpa["conv3.weight"].shape == (3, 8, 3, 3)


def _realesrgan_x2_params():
    model = create_flax("realesrgan_x2", channels=16, growth_channels=8, num_rrdb=2)
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        dict(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]))


def test_gen_rrdb2x_tree_is_never_taken_for_a_realesrgan_one():
    """The two trees have the same module names and the same 12-channel
    conv1; ``Conv_4`` is ``gen_rrdb2x``'s last conv and Real-ESRGAN's HR
    conv. The dispatch sends each to its own mapping, and each mapping
    refuses the other's tree."""
    ours, theirs = _params("gen_rrdb2x"), _realesrgan_x2_params()
    assert _leaves(ours).keys() == _leaves(theirs).keys()
    assert _leaves(ours)["Conv_0/Conv_0/kernel"].shape == _leaves(theirs)["Conv_0/Conv_0/kernel"].shape
    assert "conv_first.weight" in flax_to_state_dict(ours)
    assert "conv1.weight" in flax_to_state_dict(theirs) and "conv4.weight" in flax_to_state_dict(theirs)
    assert flax_to_state_dict(theirs)["conv4.weight"].shape == (3, 16, 3, 3)
    for fn in (realesrgan_flax_to_state_dict, rrdb_flax_to_state_dict):
        with pytest.raises(ValueError, match="gen_rrdb2x"):
            fn(ours)
    with pytest.raises(ValueError, match="Conv_4 the last conv"):
        gen_rrdb_flax_to_state_dict(theirs)


def test_bridge_refusals():
    rrdb, rpa = _params("gen_rrdb2x"), _params("gen_rpa2x")
    with pytest.raises(ValueError, match="cannot place 1 leaves"):
        flax_to_state_dict({**rrdb, "Extra_0": {"kernel": np.zeros(1)}})
    with pytest.raises(ValueError, match="cannot place 1 leaves"):
        gen_rpa_flax_to_state_dict({**rpa, "_RPABlock_0": {**rpa["_RPABlock_0"], "Dense_0": {"kernel": np.zeros(1)}}})
    with pytest.raises(ValueError, match="found no 'Conv_3'"):
        flax_to_state_dict({**rpa, "_RPABlock_1": {k: v for k, v in rpa["_RPABlock_1"].items() if k != "Conv_3"}})
    with pytest.raises(ValueError, match="Conv_0..Conv_2"):
        gen_rpa_flax_to_state_dict(rrdb)
    # output channels equal to the features: the shapes cannot tell the trees apart
    square = {**rrdb, "Conv_4": {"Conv_0": {"kernel": np.zeros((3, 3, 16, 16)), "bias": np.zeros(16)}}}
    with pytest.raises(ValueError, match="only Conv_4's or Conv_5's output channels"):
        flax_to_state_dict(square)


# -- the CLIs -------------------------------------------------------------------------------


def _write_png(path, h, w, seed):
    img = (np.random.default_rng(seed).uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(path), img)
    return img


def _want_png(arch, bgr):
    """The JAX module's SR of a BGR uint8 frame as the CLIs write it."""
    x = (np.asarray(bgr[..., ::-1], np.float32) / 255.0)[None]
    sr = np.asarray(_jax_fn(arch)(jnp.asarray(x)))[0]
    return np.clip(sr * 255.0, 0, 255).astype(np.uint8)[..., ::-1]


def _assert_within_a_level(path, want):
    got = cv2.imread(str(path))
    assert got is not None and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    """The CLIs build the tiny models (they build full width), loading the
    weights from a ``.npz`` of each Flax tree."""
    real = create_model
    monkeypatch.setattr(port_infer, "create_model", lambda arch, **kw: real(arch, **{**kw, **TINY[arch]}))
    paths = {}
    for arch in ARCHS:
        paths[arch] = str(tmp_path / f"{arch}.npz")
        np.savez(paths[arch], **_leaves(_params(arch)))
    return paths


@pytest.mark.parametrize("arch", ARCHS)
def test_infer_and_stdio_serve_match_jax(arch, tiny_cli, tmp_path, monkeypatch):
    """``cli.infer`` of one frame and ``cli.serve --stdio`` of two: each PNG
    within one 8-bit level of the JAX module's output (the CLIs clip the
    unclamped output to [0, 1]); ``gen_rrdb2x`` replies ``ok: false`` to an
    odd frame unless ``--bucket 2``."""
    img = _write_png(tmp_path / "in.png", 14, 18, 20)
    port_infer.main(["--model-arch", arch, "--inputs-path", str(tmp_path / "in.png"), "--output-path",
                     str(tmp_path / "infer.png"), "--weights", tiny_cli[arch], "--device-type", "cpu"])
    _assert_within_a_level(tmp_path / "infer.png", _want_png(arch, img))

    odd = _write_png(tmp_path / "odd.png", 13, 18, 21)
    reqs = [{"input": str(tmp_path / n), "output": str(tmp_path / f"sr_{n}"), "id": i}
            for i, n in enumerate(("in.png", "odd.png"))]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"))
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        port_serve.main(["--stdio", "--model-arch", arch, "--weights", tiny_cli[arch], "--device-type", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    assert replies[0]["ok"] and replies[0]["out_hw"] == [28, 36]
    _assert_within_a_level(tmp_path / "sr_in.png", _want_png(arch, img))
    if arch == "gen_rrdb2x":
        assert not replies[1]["ok"] and "--bucket 2" in replies[1]["error"]
    else:
        assert replies[1]["ok"]
        _assert_within_a_level(tmp_path / "sr_odd.png", _want_png(arch, odd))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_test_evaluates_the_arch_by_g_arch(arch, tmp_path, monkeypatch):
    """``cli.test``'s ``g_arch`` override under the ``bsrgan`` config (x2),
    LR from ``--lr-dir``, weights from a ``.pth``: each saved SR frame
    within one 8-bit level of the JAX module's SR of the bucket-padded LR,
    and finite metrics."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "gt").mkdir()
    (tmp_path / "lr").mkdir()
    lrs = []
    for i, (h, w) in enumerate([(36, 36), (40, 32)]):
        gt = _write_png(tmp_path / "gt" / f"f{i}.png", 2 * h, 2 * w, 30 + i)
        lrs.append(np.ascontiguousarray(gt[::2, ::2]))
        cv2.imwrite(str(tmp_path / "lr" / f"f{i}.png"), lrs[-1])
    torch.save({"state_dict": {k: _t(v) for k, v in flax_to_state_dict(_params(arch)).items()}}, tmp_path / "g.pth")
    args = argparse.Namespace(
        config="bsrgan", gt_dir=str(tmp_path / "gt"), lr_dir=str(tmp_path / "lr"), weights=str(tmp_path / "g.pth"),
        save_images=True, max_images=0, subdivision_lpips=False, save_discriminator_eval=False,
        save_attention_layers=False, niqe_model="", niqe_impl="auto", tiny=False, use_ema=False,
        exact_shapes=False, self_ensemble=False, tile=0, tile_overlap=16, codec="diffjpeg",
        g_arch=arch, g_kwargs=TINY[arch], device="cpu")
    out = port_test.run_eval(args)
    assert all(np.isfinite(out["avg"][k]) for k in ("PSNR", "SSIM", "LPIPS"))
    assert out["generator_shapes"] == 2  # 64 x 64 and 64 x 32: LR buckets of 32
    saved = sorted(glob.glob(str(tmp_path / "**" / "sr_*.png"), recursive=True))
    assert len(saved) == 2
    for path, lr in zip(saved, lrs):
        padded = np.pad(lr, ((0, -lr.shape[0] % 32), (0, -lr.shape[1] % 32), (0, 0)), mode="reflect")
        want = _want_png(arch, padded)[: 2 * lr.shape[0], : 2 * lr.shape[1]]
        _assert_within_a_level(path, want)


# -- training --------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_step_matches_jax(arch):
    """One f32 step of the ``bsrnet`` config with ``g_arch`` overridden, from
    one Flax init on one (gt, lr) batch, against the JAX ``Trainer``'s, at
    the ``bsrnet`` lockstep's bounds: the loss rtol 2e-6, atol 2e-7; G and
    EMA-G rtol 5e-4, atol 2e-6."""
    over = dict(compute_dtype="float32", g_arch=arch, g_kwargs=TINY[arch])
    rng = np.random.default_rng(42)
    gt = rng.uniform(size=(2, 24, 24, 3)).astype(np.float32)
    lr = np.ascontiguousarray(gt[:, ::2, ::2])
    jtr = JaxTrainer(jax_configs.get_config("bsrnet", **over), steps_per_epoch=1)
    jst = jax.jit(jtr.init_state, static_argnums=(1, 2))(jax.random.PRNGKey(0), lr.shape, gt.shape)
    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    tr = Trainer(configs.get_config("bsrnet", **over), steps_per_epoch=1)
    st = tr.init_state(init)
    assert type(st.g_model).__name__ == {"gen_rrdb2x": "GeneratorRRDB", "gen_rpa2x": "GeneratorRPA"}[arch]
    jst, m = jtr.train_step(jst, jnp.asarray(gt), jnp.asarray(lr))
    out = tr.train_step(st, _t(gt), _t(lr))
    np.testing.assert_allclose(float(out["pixel_loss"]), float(m["pixel_loss"]), rtol=2e-6, atol=2e-7)
    for name, ours, theirs in (("G", dict(st.g_model.named_parameters()), jst.g_params),
                               ("EMA-G", st.ema_g, jst.ema_g_params)):
        want = flax_to_state_dict(theirs)
        assert set(ours) == set(want)
        for k in sorted(want):
            np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(want[k]), rtol=5e-4, atol=2e-6,
                                       err_msg=f"{name} {k}")
    moved = max(float((st.g_model.state_dict()[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-5, f"suspiciously small update {moved}"
