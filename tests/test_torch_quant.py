"""The port's int8 serving path (``ops/quant.py``, the quantized RDB and the
generators' ``quant`` field, ``--quant-int8`` in ``cli.infer`` and
``cli.serve``) against the JAX package's ``quant=True`` on the same numpy
inputs and converted weights (tiny widths: 16 channels, growth 8, 2
RRDBs). On the CPU the s8 conv is its plain version, an exact float64
conv; the kernel's own cases are in ``test_torch_cuda.py``."""

import functools
import io
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.models.blocks import ResidualDenseBlock as FlaxRDB
from srganfd_tpu.ops import quant as jax_quant
from srganfd_tpu_torch.cli import infer as port_infer
from srganfd_tpu_torch.cli import serve as port_serve
from srganfd_tpu_torch.convert import flax_to_state_dict
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.models.blocks import ResidualDenseBlock
from srganfd_tpu_torch.ops import quant
from srganfd_tpu_torch.ops.cuda import qconv
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CH, GC = 16, 8


def _draw(rng, shape, gain=1.0):
    fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else 1
    return (rng.normal(size=shape) * gain / np.sqrt(fan_in)).astype(np.float32)


@pytest.mark.parametrize("axis", [None, 3, 0], ids=["per_tensor", "per_out_channel", "axis0"])
def test_quantize_symmetric_is_bit_equal_to_jax(axis):
    """q and scale bit for bit, ties at .5 included (a grid of x / scale
    values on exact halves rounds half to even in both)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 3, 24, 40)).astype(np.float32)
    x[0, 0, 0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 0.0], np.float32) / 127 * 4
    x[1, 1, 1, 1] = 4.0  # the per-tensor absmax: scale 4 / 127
    q, s = quant.quantize_symmetric(torch.from_numpy(x), axis)
    jq, js = jax_quant.quantize_symmetric(jnp.asarray(x), axis)
    diff = int((q.numpy() != np.asarray(jq)).sum())
    print(f"quantize_symmetric axis={axis}: {diff} of {q.numel()} q values differ")
    assert q.dtype == torch.int8 and diff == 0
    assert s.shape == tuple(js.shape) and np.array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(quant.dequantize(q, s).numpy(), np.asarray(jax_quant.dequantize(jq, js)))


def test_quantize_symmetric_of_zeros_uses_the_floor():
    q, s = quant.quantize_symmetric(torch.zeros(4, 5))
    assert float(s) == np.float32(1e-12) / np.float32(127.0) and not q.any()


@pytest.mark.parametrize("cin,cout,shape", [(16, 40, (2, 9, 11)), (32, 64, (1, 6, 5)), (8, 8, (1, 1, 1))])
def test_qconv2d_is_bit_equal_to_jax(cin, cout, shape):
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    k = _draw(rng, (3, 3, cin, cout))
    got = quant.qconv2d(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    want = np.asarray(jax_quant.qconv2d(jnp.asarray(x), jnp.asarray(k)))
    print(f"qconv2d cin={cin} cout={cout}: {int((got != want).sum())} of {got.size} outputs differ")
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_qconv_plain_sums_are_exact_at_the_extremes():
    """All +-127 operands at cin 64: sums of 127^2 * 9 * 64, the int32 the
    kernel holds, equal to an integer conv in int64."""
    xq = torch.full((1, 4, 4, 64), 127, dtype=torch.int8)
    kq = torch.full((3, 3, 64, 8), -127, dtype=torch.int8)
    acc = qconv.qconv3x3_ref(xq, kq)
    assert acc.dtype == torch.int32 and int(acc[0, 1, 1, 0]) == -(127 * 127 * 9 * 64)
    assert int(acc[0, 0, 0, 0]) == -(127 * 127 * 4 * 64)  # the corner sees 4 taps


def test_pack_qconv_weights_layout():
    kq = torch.arange(3 * 3 * 64 * 24, dtype=torch.int32).remainder(251).sub(125).to(torch.int8).reshape(3, 3, 64, 24)
    w = qconv.pack_qconv_weights(kq).reshape(2, 9, 32, 32)  # cout 24 padded to 32
    for c in (0, 1):
        for tap in (0, 4, 8):
            assert torch.equal(w[c, tap, :24], kq[tap // 3, tap % 3, 32 * c:32 * (c + 1)].t())
    assert not w[:, :, 24:].any()
    with pytest.raises(ValueError, match="multiple of 32"):
        qconv.pack_qconv_weights(torch.zeros(3, 3, 48, 8, dtype=torch.int8))


def _rdb_params(rng):
    p = {}
    for k in range(5):
        cin, cout = CH + k * GC, GC if k < 4 else CH
        p[f"conv{k}_kernel"] = _draw(rng, (3, 3, cin, cout), np.sqrt(2.0))
        p[f"conv{k}_bias"] = (rng.normal(size=cout) * 0.1).astype(np.float32)
    return p


def _port_rdb(p):
    m = ResidualDenseBlock(CH, GC, quant=True)
    with torch.no_grad():
        for k in range(5):
            conv = getattr(m, f"conv{k + 1}")
            conv.weight.copy_(torch.from_numpy(p[f"conv{k}_kernel"]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(p[f"conv{k}_bias"]))
    return m.requires_grad_(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_rdb_matches_jax(dtype):
    """The fused int8 RDB: f32 to 1e-6 max abs; bf16 within one bf16 step
    of the largest output (the two frameworks round bf16 products at other
    points)."""
    rng = np.random.default_rng(7)
    p = _rdb_params(rng)
    x = rng.normal(size=(2, 10, 9, CH)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(FlaxRDB(CH, GC, jdt, quant=True).apply({"params": p}, jnp.asarray(x, jdt)), np.float32)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = _port_rdb(p)(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
    err = float(np.abs(got - want).max())
    limit = 1e-6 if dtype == "float32" else 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    print(f"quantized RDB {dtype}: max abs {err:.3g} (limit {limit:.3g})")
    assert err <= limit


def test_quantized_rdb_weights_are_quantized_once_per_parameter_version():
    m = _port_rdb(_rdb_params(np.random.default_rng(3)))
    first = m.quantized()
    assert m.quantized() is first
    with torch.no_grad():
        m.conv3.weight.mul_(2.0)
    second = m.quantized()
    # q is scale-free: doubling conv3 doubles its columns' scales in every source it reads
    assert second is not first and torch.equal(second[0][0], first[0][0])
    assert torch.equal(second[0][1][2 * GC:3 * GC], 2 * first[0][1][2 * GC:3 * GC])


def test_quantized_rdb_raises_under_grad():
    m = ResidualDenseBlock(CH, GC, quant=True)
    with pytest.raises(RuntimeError, match="serves only"):
        m(torch.zeros(1, CH, 4, 4))
    with torch.no_grad():
        assert m(torch.zeros(1, CH, 4, 4)).shape == (1, CH, 4, 4)


GEN_ARCHS = ["bsrgan_x2", "realesrgan_x4"]


def _tiny(arch):
    depth = "num_blocks" if arch.startswith("rrdbnet") else "num_rrdb"
    return {"channels": CH, "growth_channels": GC, depth: 2}


@functools.cache
def _gen_params(arch):
    model = create_flax(arch, **_tiny(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.float32))
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: _draw(rng, s.shape) if len(s.shape) == 4 else (rng.normal(size=s.shape) * 0.1).astype(np.float32),
        dict(shapes["params"]))
    last = max((k for k in params if k.startswith("Conv_")), key=lambda k: int(k[5:]))
    params[last]["Conv_0"]["bias"] += 0.5
    return params


def _generator_outputs(arch, dtype, quant_on, x):
    """(port, JAX) outputs of the tiny ``arch`` in ``dtype`` on the same
    converted weights."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    flax = create_flax(arch, **_tiny(arch), dtype=jdt, quant=quant_on)
    want = np.asarray(jax.jit(flax.apply)({"params": _gen_params(arch)}, jnp.asarray(x)), np.float32)
    model = create_model(arch, dtype=getattr(torch, dtype), quant=quant_on, **_tiny(arch))
    model.load_state_dict({k: torch.tensor(v) for k, v in flax_to_state_dict(_gen_params(arch)).items()})
    with torch.inference_mode():
        return model.eval()(torch.from_numpy(x)).float().numpy(), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_quantized_generator_matches_jax(arch, dtype):
    """f32: 1e-6 max abs. bf16: the trunk rounds at the JAX points
    (test_quantized_rdb_matches_jax holds it to one bf16 step); the convs
    outside it do not (XLA adds the bias to the rounded bf16 conv output,
    oneDNN before rounding), which the UNQUANTIZED bf16 generator against
    JAX shows (read here beside it). So the int8 path is held to what it
    adds: its max and mean abs against JAX may exceed the unquantized
    pair's by at most one bf16 step of the largest output (max) and a
    quarter step (mean); and, as a whole, to test_torch_generator's bf16
    limit of 2^-6 (2 bf16 steps at 1.0) and a mean of 2^-8."""
    x = np.random.default_rng(5).uniform(size=(2, 12, 8, 3)).astype(np.float32)
    got, want = _generator_outputs(arch, dtype, True, x)
    err, mean = float(np.abs(got - want).max()), float(np.abs(got - want).mean())
    assert got.shape == want.shape
    if dtype == "float32":
        print(f"{arch} quant f32: max abs {err:.3g}, mean abs {mean:.3g} (limit 1e-06)")
        assert err <= 1e-6
        return
    got_u, want_u = _generator_outputs(arch, dtype, False, x)
    err_u, mean_u = float(np.abs(got_u - want_u).max()), float(np.abs(got_u - want_u).mean())
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    print(f"{arch} bf16 against JAX: quant max abs {err:.4g}, mean {mean:.4g}; unquantized max abs {err_u:.4g}, "
          f"mean {mean_u:.4g}; one bf16 step of the largest output {step:.4g}")
    assert err <= err_u + step and mean <= mean_u + step / 4
    assert err <= 2.0**-6 and mean <= 2.0**-8


def _png(path, h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    cv2.imwrite(str(path), img)


def test_cli_infer_quant_int8_writes_a_frame(tmp_path, monkeypatch):
    """Full-width bsrgan_x2 under --quant-int8 on a 12x12 frame: the
    quantized model's output, written as a PNG."""
    _png(tmp_path / "in.png", 12, 12, 0)
    seen = []
    real = create_model
    monkeypatch.setattr(port_infer, "create_model", lambda arch, **kw: seen.append(kw) or real(arch, **kw))
    port_infer.main(["--device-type", "cpu", "--model-arch", "bsrgan_x2", "--quant-int8",
                     "--inputs-path", str(tmp_path / "in.png"), "--output-path", str(tmp_path / "o.png")])
    assert seen[0]["quant"] is True
    assert cv2.imread(str(tmp_path / "o.png")).shape == (24, 24, 3)


def test_cli_infer_quant_int8_is_ignored_on_gen_rrdb2x(tmp_path, capsys):
    _png(tmp_path / "in.png", 8, 8, 1)
    port_infer.main(["--device-type", "cpu", "--model-arch", "gen_rrdb2x", "--quant-int8",
                     "--inputs-path", str(tmp_path / "in.png"), "--output-path", str(tmp_path / "o.png")])
    assert "! --quant-int8 ignored: arch 'gen_rrdb2x' has no RDB trunk" in capsys.readouterr().out
    assert cv2.imread(str(tmp_path / "o.png")).shape == (16, 16, 3)


def test_serving_engine_quant_int8_serves_stdio(tmp_path):
    """ServingEngine(quant_int8=True) builds the quantized model and answers
    over stdio; its reply equals the quantized model's own SR of the frame."""
    _png(tmp_path / "a.png", 10, 8, 2)
    engine = port_serve.ServingEngine("bsrgan_x2", quant_int8=True, device="cpu",
                                      model_kwargs={"channels": CH, "growth_channels": GC, "num_rrdb": 1})
    assert all(m.quant for m in engine.model.modules() if isinstance(m, ResidualDenseBlock))
    out = io.StringIO()
    req = {"id": 1, "input": str(tmp_path / "a.png"), "output": str(tmp_path / "sr.png")}
    port_serve.serve_stdio(engine, inp=io.StringIO(json.dumps(req) + "\n"), out=out)
    reply = json.loads(out.getvalue().splitlines()[0])
    assert reply["ok"] and reply["out_hw"] == [20, 16]
    from srganfd_tpu_torch.data.datasets import load_image_rgb

    want = np.clip(engine.sr_array(load_image_rgb(str(tmp_path / "a.png"))) * 255.0, 0, 255).astype(np.uint8)
    assert np.array_equal(cv2.imread(str(tmp_path / "sr.png"))[..., ::-1], want)
