"""``srganfd_tpu_torch.cli.test`` (``run_eval``) against the JAX package's
``srganfd_tpu.cli.test.run_eval`` on the CPU: one tiny directory, the same
weights (JAX reads them from an Orbax checkpoint written from its params,
the port from a ``.pth`` converted through ``convert.py``), one LPIPS
``.npz`` for both through ``$SRGANFD_LPIPS_NPZ`` (written from the JAX
surrogate, since the two seeded surrogates differ). Per-image metrics of
the JAX run are read by wrapping its metric functions in the module's
namespace (nothing in the JAX package changes).

Cases: ``rrdbnet`` (bicubic LR; bucketed and ``--exact-shapes``,
``--lr-dir``, ``--self-ensemble``; ``generator_shapes`` against JAX's
``generator_compiles``), ``bsrgan`` (the eval chain; D heat-maps) and
``aesrgan`` (the attention D's gate maps in eval mode, on non-trivial
running statistics); then ``select_niqe_impl``'s rule and the refusals.
Tiny generators (``--tiny``: 8 channels, growth 4, one block); the
discriminators keep their width.
"""

import argparse
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.cli import test as jax_test
from srganfd_tpu.losses.lpips import Lpips as JaxLpips
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.track import tracker as jax_tracker
from srganfd_tpu.train import checkpoint as jax_ckpt
from srganfd_tpu_torch.cli import test as port_test
from srganfd_tpu_torch.convert import (
    alexnet_flax_to_state_dict,
    attention_discriminator_flax_to_state_dict,
    discriminator_flax_to_state_dict,
    flax_to_state_dict,
)
from srganfd_tpu_torch.track import tracker
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY = {"channels": 8, "growth_channels": 4}
# (g arch, its --tiny kwargs, d arch, the D's bridge) of each config
CONFIGS = {
    "rrdbnet": ("rrdbnet_x4", {**TINY, "num_blocks": 1}, None, None),
    "bsrgan": ("bsrgan_x2", {**TINY, "num_rrdb": 1}, "discriminator_unet", "sn"),
    "aesrgan": ("bsrgantrans_x2", {**TINY, "num_rrdb": 1}, "uNetDiscriminatorAesrgan", "attention"),
}
# (PSNR dB, SSIM, LPIPS) per image and on average. Bicubic LR: the same
# f32 arithmetic on both sides. The chain configs' LR passes DiffJPEG,
# whose rounding can flip an 8-bit level (the chain goldens' envelope, max
# 0.05 of one LR pixel, tests/test_chain_goldens.py); no level flipped on
# these frames: measured 6.1e-7 dB, 3.0e-8 and 3.3e-5 (bsrgan's four
# quadrants of LPIPS) apart, held at 1e-3 dB, 1e-5 and 1e-4.
TOL = {"bicubic": (1e-4, 1e-6, 1e-6), "chain": (1e-3, 1e-5, 1e-4)}


@pytest.fixture(autouse=True)
def _quiet_sinks(monkeypatch, lpips):
    """JSONL only (TensorBoard's writer would import TensorFlow), one LPIPS
    for both packages."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)
    monkeypatch.setattr(jax_tracker, "SummaryWriter", None)
    monkeypatch.setenv("SRGANFD_LPIPS_NPZ", lpips[1])


@pytest.fixture(scope="module")
def lpips(tmp_path_factory):
    """The JAX surrogate (built once: its init takes seconds) and an .npz of
    its weights for the port."""
    jax_lpips = JaxLpips()
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    lins = {f"lin.{i}.weight": np.asarray(w, np.float32).reshape(1, -1, 1, 1) for i, w in enumerate(jax_lpips.lins)}
    np.savez(path, **alexnet_flax_to_state_dict(jax_lpips.variables["params"]), **lins)
    return jax_lpips, str(path)


def _write(d, sizes, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 32.0
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 2) + yy * rng.uniform(0.5, 2)))
        img = np.clip(base[..., None] + 0.05 * rng.standard_normal((h, w, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"im{i}.png"), (img * 255).astype(np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    # three sizes in three buckets of 64 (128x128, 64x128, 64x64), one of them a multiple already
    return _write(tmp_path_factory.mktemp("gt"), [(70, 90), (60, 100), (64, 64)], 0)


@pytest.fixture(scope="module")
def chain_dirs(tmp_path_factory):
    """bsrgan: one frame with sides of 134+, so that --subdivision-lpips'
    quadrants pass AlexNet's pools; aesrgan: two frames in one bucket of
    64."""
    return {"bsrgan": _write(tmp_path_factory.mktemp("bsrgan_gt"), [(136, 150)], 1),
            "aesrgan": _write(tmp_path_factory.mktemp("aesrgan_gt"), [(64, 64), (50, 60)], 2)}


def _filled(tree, seed):
    """Params of a tree filled from a numpy seed: kernels N(0, 1/fan_in),
    biases N(0, 0.1), scales 1 + N(0, 0.1), so that SR spreads over [0, 1]
    instead of sitting near 0 as at the x0.1 init."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            parent = str(getattr(path[-2], "key", path[-2]))
            # DenseGeneral: (C, H, D) projections contract C, the (H, D, C) "out" contracts H x D
            fan_in = shape[0] if len(shape) == 3 and parent != "out" else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape) + (0.5 if len(shape) == 1 and shape[0] == 3 else 0)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Per config: (the JAX checkpoint directory, the port's .pth). G,
    EMA-G and D filled from seeds, D's ``u`` normal and, for the attention
    D, its running statistics random."""
    out = {}
    root = tmp_path_factory.mktemp("weights")
    for name, (g_arch, g_kwargs, d_arch, bridge) in CONFIGS.items():
        g_model = create_flax(g_arch, **g_kwargs)
        shapes = jax.eval_shape(g_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
        g, ema = _filled(shapes, 1), _filled(shapes, 2)
        state = {"step": 5, "g_params": g, "ema_g_params": ema}
        payload = {"step": 5, "epoch": 0, "state_dict": _torch(flax_to_state_dict(g)),
                   "ema_state_dict": _torch(flax_to_state_dict(ema))}
        if d_arch:
            shapes = jax.eval_shape(create_flax(d_arch).init, jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
            rng = np.random.default_rng(4)

            def stat(path, a):  # u ~ N(0, 1); running means N(0, 0.2^2), variances U(0.5, 2)
                name = path[-1].key
                v = rng.uniform(0.5, 2.0, a.shape) if name == "var" else rng.standard_normal(a.shape)
                return (0.2 * v if name == "mean" else v).astype(np.float32)

            variables = {k: _filled(v, 3) if k == "params" else jax.tree_util.tree_map_with_path(stat, v)
                         for k, v in shapes.items()}
            state["d_params"] = variables["params"]
            state["d_vars"] = {k: v for k, v in variables.items() if k != "params"}
            d_sd = (discriminator_flax_to_state_dict(variables["params"], variables["spectral"]) if bridge == "sn"
                    else attention_discriminator_flax_to_state_dict(variables["params"], variables["batch_stats"],
                                                                    variables["spectral"]))
            payload["d_state_dict"] = _torch(d_sd)
        jax_ckpt.save_checkpoint(str(root / name), state, 0, {"psnr": 0.0}, True)
        torch.save(payload, root / f"{name}.pth")
        out[name] = (str(root / name / "ckpt_last"), str(root / f"{name}.pth"))
    return out


def _torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _args(**kw):
    base = dict(config="rrdbnet", gt_dir="", lr_dir="", weights="", save_images=False, max_images=0,
                subdivision_lpips=False, save_discriminator_eval=False, save_attention_layers=False,
                niqe_model="", niqe_impl="auto", tiny=True, use_ema=False, exact_shapes=False,
                self_ensemble=False, tile=0, tile_overlap=16, codec="diffjpeg")
    base.update(kw)
    return argparse.Namespace(**base)


def _jax_eval(monkeypatch, jax_lpips, **kw):
    """JAX ``run_eval`` and each image's PSNR, SSIM and LPIPS, read by
    wrapping its metric functions; its LPIPS is ``jax_lpips``, the
    surrogate whose weights the port reads from the .npz."""
    seen = {"psnr": [], "ssim": [], "lpips": []}
    real = {"psnr": jax_test.psnr_tensor_padded, "ssim": jax_test.ssim_tensor_padded}

    def wrap(key):
        def fn(*a, **k):
            v = real[key](*a, **k)
            seen[key].append(float(v[0]))
            return v
        return fn

    def recorded(a, b):
        v = jax_lpips(a, b)
        seen["lpips"].append(float(v[0]))
        return v

    recorded.pretrained = True

    class CheckpointOnly:
        """A JAX module whose ``init`` is skipped: the JAX CLI inits the D
        (tens of seconds, op by op, here) and then replaces its variables
        with the checkpoint's, which every run here holds."""

        def __init__(self, module):
            self.module = module

        def init(self, *a, **k):
            return None

        def apply(self, *a, **k):
            return self.module.apply(*a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(jax_test, "create_model", lambda name, **k: CheckpointOnly(create_flax(name, **k)))
        mp.setattr(jax_test, "psnr_tensor_padded", wrap("psnr"))
        mp.setattr(jax_test, "ssim_tensor_padded", wrap("ssim"))
        mp.setattr(jax_test, "Lpips", lambda: recorded)
        out = jax_test.run_eval(_args(**kw))
    return out, seen


def _compare(jax_out, seen, port_out, tol, subdivision=False):
    (dp, ds, dl) = tol
    per = port_out["per_image"]
    lp_jax = seen["lpips"]
    if subdivision:
        lp_jax = [float(np.mean(lp_jax[i:i + 4])) for i in range(0, len(lp_jax), 4)]
    assert len(per) == len(seen["psnr"]) == len(lp_jax)
    for r, p, s, lp in zip(per, seen["psnr"], seen["ssim"], lp_jax):
        assert abs(r["psnr"] - p) <= dp, (r, p)
        assert abs(r["ssim"] - s) <= ds, (r, s)
        assert abs(r["lpips"] - lp) <= dl, (r, lp)
    for k, d in (("PSNR", dp), ("SSIM", ds), ("LPIPS", dl)):
        assert abs(port_out["avg"][k] - jax_out["avg"][k]) <= d, (k, port_out["avg"], jax_out["avg"])


@pytest.mark.parametrize("mode", ["bucketed", "exact_shapes", "lr_dir", "self_ensemble"])
def test_rrdbnet_eval_matches_jax(gt_dir, weights, lpips, tmp_path, monkeypatch, mode):
    """``rrdbnet`` (bicubic LR) on three frame sizes: per-image and average
    PSNR/SSIM/LPIPS to ``TOL["bicubic"]``, and the generator's distinct
    input shapes equal to the JAX CLI's compiled programs (3 buckets; 3
    sizes exact; the LR dir's buckets; the ensemble's shapes and their
    transposes)."""
    kw = {"gt_dir": gt_dir}
    if mode == "exact_shapes":
        kw["exact_shapes"] = True
    elif mode == "self_ensemble":
        kw["self_ensemble"] = True
    elif mode == "lr_dir":
        lr = _write(tmp_path / "lr", [(18, 22), (15, 25), (16, 16)], 5)
        kw["lr_dir"] = lr
    jax_w, port_w = weights["rrdbnet"]
    monkeypatch.chdir(tmp_path)
    jax_out, seen = _jax_eval(monkeypatch, lpips[0], weights=jax_w, **kw)
    port_out = port_test.run_eval(_args(weights=port_w, device="cpu", **kw))
    _compare(jax_out, seen, port_out, TOL["bicubic"])
    assert port_out["generator_shapes"] == jax_out["generator_compiles"], (port_out, jax_out)
    assert port_out["avg"]["PSNR"] > 10  # the filled weights make a real image, not a flat one


def _pngs(d, prefix):
    return {f: cv2.imread(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.startswith(prefix)}


@pytest.mark.parametrize("config", ["bsrgan", "aesrgan"])
def test_chain_config_eval_matches_jax(chain_dirs, weights, lpips, tmp_path, monkeypatch, config):
    """``bsrgan`` with ``--save-discriminator-eval --subdivision-lpips
    --use-ema`` and ``aesrgan`` with ``--save-attention-layers
    --save-discriminator-eval``: the BSRGAN eval chain's LR (the same plan
    on both sides), the metrics within the chain's envelope
    (``TOL["chain"]``), and the discriminator in eval mode: D(gt)'s heat-map
    (identical input on both sides) and, for ``aesrgan``, the three gate
    maps of D(sr), as PNGs, within one 8-bit level of JAX's."""
    extra = ({"save_discriminator_eval": True, "subdivision_lpips": True, "use_ema": True} if config == "bsrgan"
             else {"save_attention_layers": True, "save_discriminator_eval": True})
    jax_w, port_w = weights[config]
    kw = {"config": config, "gt_dir": chain_dirs[config], **extra}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "jax")
    jax_out, seen = _jax_eval(monkeypatch, lpips[0], weights=jax_w, **kw)
    monkeypatch.chdir(tmp_path / "port")
    port_out = port_test.run_eval(_args(weights=port_w, device="cpu", **kw))
    _compare(jax_out, seen, port_out, TOL["chain"], subdivision=config == "bsrgan")
    (logs,) = os.listdir(tmp_path / "port" / "samples" / "logs")
    got_dir, want_dir = (str(tmp_path / side / "samples" / "logs" / logs) for side in ("port", "jax"))
    prefixes = ["d_gt_"] + (["attn"] if config == "aesrgan" else [])
    for prefix in prefixes:
        got, want = _pngs(got_dir, prefix), _pngs(want_dir, prefix)
        assert got and set(got) == set(want), (sorted(got), sorted(want))
        for f in got:
            assert got[f].shape == want[f].shape, f
            assert np.abs(got[f].astype(int) - want[f].astype(int)).max() <= 1, f
    assert len(_pngs(got_dir, "d_sr_")) == len(port_out["per_image"])


def test_niqe_impl_auto_selection_rule():
    """The JAX rule, case by case: 'auto' keeps the twin up to the pixel
    budget and takes numpy above it; explicit choices hold."""
    small, big = 128 * 128, 1280 * 960
    assert port_test.NIQE_AUTO_MODULE_MAX_PIXELS == jax_test.NIQE_AUTO_MODULE_MAX_PIXELS
    for impl in ("auto", "module", "numpy"):
        for available in (True, False):
            for n in (small, port_test.NIQE_AUTO_MODULE_MAX_PIXELS, big):
                assert port_test.select_niqe_impl(impl, available, n) == jax_test.select_niqe_impl(impl, available, n)


def test_niqe_on_the_ported_asset(tmp_path, monkeypatch):
    """``--niqe-model`` with the port's copy of the pristine model: frames
    of 2+ blocks of 96 px get a finite score; a frame below that skips its
    NIQE (a ValueError, where the JAX twin raises a RuntimeError)."""
    asset = os.path.join(os.path.dirname(port_test.__file__), "..", "assets", "niqe_cfd_bubbles.npz")
    gt = _write(tmp_path / "gt", [(100, 200), (60, 60)], 7)
    monkeypatch.chdir(tmp_path)
    out = port_test.run_eval(_args(gt_dir=gt, niqe_model=asset, device="cpu"))
    niqe = [r["niqe"] for r in out["per_image"]]
    assert np.isfinite(niqe[0]) and np.isnan(niqe[1])
    assert out["avg"]["NIQE"] == pytest.approx(np.clip(niqe[0], 0, 100))  # the clamped average


@pytest.mark.parametrize("case", ["npz_weights", "multiscale_heatmaps", "ensemble_with_tile"])
def test_refusals(gt_dir, weights, tmp_path, monkeypatch, capsys, case):
    """``--weights *.npz`` (Flax paths, the JAX CLI's other weights source)
    evaluates the G it holds exactly as the ``.pth`` of the same G, and
    ``--use-ema`` on it prints the JAX notice; the two-scale D's heat-maps
    (one logit map per scale: the JAX CLI fails on the tuple's ``.ndim``)
    raise a ValueError naming the cause; the ensemble with tiles exits, as
    in JAX."""
    monkeypatch.chdir(tmp_path)
    if case == "npz_weights":
        from srganfd_tpu_torch.convert import flatten_flax, state_dict_to_flax

        port_w = weights["rrdbnet"][1]
        sd = torch.load(port_w, weights_only=True)["state_dict"]
        np.savez(tmp_path / "w.npz", **flatten_flax(state_dict_to_flax(sd, 1)))
        want = port_test.run_eval(_args(gt_dir=gt_dir, weights=port_w, max_images=2, device="cpu"))
        got = port_test.run_eval(_args(gt_dir=gt_dir, weights="w.npz", max_images=2, use_ema=True, device="cpu"))
        assert "! --use-ema ignored: .npz weights carry a single param tree" in capsys.readouterr().out
        assert got["avg"] == want["avg"] and got["avg"]["PSNR"] > 10
    elif case == "multiscale_heatmaps":
        with pytest.raises(ValueError, match="one logit map per scale"):
            port_test.run_eval(_args(config="aesrgan", gt_dir=gt_dir, max_images=1, save_discriminator_eval=True,
                                     d_arch="discriminator_attention_unet_ms", device="cpu"))
    else:
        with pytest.raises(SystemExit, match="cannot combine"):
            port_test.run_eval(_args(gt_dir=gt_dir, self_ensemble=True, tile=32, device="cpu"))


def test_codec_cv2_takes_every_jpeg_stage_through_cv2(gt_dir, tmp_path, monkeypatch):
    """``--codec cv2``: the BSRGAN chain's JPEG stages are the reference's
    cv2 round trip (one or two a frame: the final always, the mid one where
    its plan fires), the LR the JAX chain's with the cv2 codec on the same
    plan to one 8-bit level (its blurs and resizes differ by f32 roundoff,
    which can move a JPEG input across a rounding edge)."""
    import srganfd_tpu_torch.ops.degrade as port_degrade
    from srganfd_tpu.cli.degrade_adapter import DegradationAdapter as JaxAdapter
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter

    monkeypatch.chdir(tmp_path)
    calls = []
    real = port_degrade._cv2_jpeg
    monkeypatch.setattr(port_degrade, "_cv2_jpeg", lambda img, q: calls.append(q) or real(img, q))
    out = port_test.run_eval(_args(config="bsrgan", gt_dir=gt_dir, codec="cv2", max_images=1, device="cpu"))
    assert np.isfinite(out["avg"]["PSNR"]) and 1 <= len(calls) <= 2
    from srganfd_tpu_torch import configs as port_configs
    from srganfd_tpu import configs as jax_configs

    frame = np.random.default_rng(4).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    ours = DegradationAdapter(port_configs.get_config("bsrgan"), seed=3, train=False, eval_codec="cv2")
    theirs = JaxAdapter(jax_configs.get_config("bsrgan"), seed=3, train=False, eval_codec="cv2")
    for step in range(3):
        got = ours({"gt": frame}, step)["lr"].numpy()
        want = np.asarray(theirs({"gt": frame}, step)["lr"])
        assert got.shape == want.shape and np.abs(got - want).max() <= 1 / 255 + 1e-6, step


def test_cli_on_the_cpu(gt_dir, tmp_path, monkeypatch, capsys):
    """``main`` with the JAX CLI's flags and ``--device-type cpu``: the
    per-image lines and the ``== PSNR:`` line in the JAX format, the
    metrics JSON and the SR PNGs; ``cuda`` without a card exits."""
    monkeypatch.chdir(tmp_path)
    port_test.main(["--config", "rrdbnet", "--gt-dir", gt_dir, "--tiny", "--save-images", "--max-images", "2",
                    "--device-type", "cpu"])
    out = capsys.readouterr().out
    assert "[1/2]" in out and "[2/2]" in out and "== PSNR:" in out and " dB  SSIM: " in out
    logs = tmp_path / "samples" / "logs" / "rrdbnet"
    assert (logs / "test_metrics.json").exists() and (logs / "sr_0001.png").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_test.main(["--config", "rrdbnet", "--gt-dir", gt_dir, "--tiny"])
