"""The trainer's dispatch modes in the port against the JAX package's:
``SRGANFD_FUSE_STEP=1`` (the BSRGAN chain, the aligned crop and the update as
one dispatch) and ``SRGANFD_STEPS_PER_DISPATCH=K`` (K steps as one dispatch,
grouped by the chain's branch key when fused, pre-degraded and in order
otherwise), and the device form of the update they run.

- The port alone: the fused step equals the adapter's composed step; K
  fused steps and K generic steps in one dispatch equal the same K single
  dispatches bit for bit (the metrics their mean); the device form (the
  lr from a table on the device, the guard a device-side select, Adam's
  bias corrections in f64 tensors) equals the host form's steps in f64 to
  roundoff; the crop takes device offsets; a step-exact resume
  under fused K-step dispatch equals the uninterrupted run.
- Against JAX, in f64 from one converted state: ``bsrnet``'s
  ``bsrgan_fused_train_multi_step`` (K = 2) and ``bsrgan_fused_train_step``,
  the guard on, the losses held to 1e-9, G and EMA-G to 5e-8 of each
  tensor's largest entry (``PARAM_TOL``: the chain runs in f32 in both, its
  LR a few ulps apart, which G's small biases carry at up to 1e-8; the D
  step's device form is held to the host form above, whose JAX lockstep is
  ``tests/test_torch_train_options.py``'s); and
  ``cli.train.run_train`` under ``SRGANFD_FUSE_STEP=1
  SRGANFD_STEPS_PER_DISPATCH=2`` (``bsrnet``) and under
  ``SRGANFD_STEPS_PER_DISPATCH=2`` (``rrdbnet``), five steps an epoch so
  that a part-filled group is flushed, both on the native loader's uint8
  crops, G and EMA-G held to ``PARAM_TOL``. The fused runs' plans are JPEG-free on
  both sides (the same draws, the JPEG stages masked off): DiffJPEG's
  roundings flip apart across frameworks (``tests/test_torch_train.py``
  bounds them at 0.02), which no lockstep survives.

The CUDA graphs themselves run on the card only (``chip_smoke.py``'s
``dispatch_phase``; ``tests/test_torch_dispatch_cuda.py``). Tiny widths;
inputs made with numpy from seeds.
"""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.cli import train as jax_cli_train
from srganfd_tpu.ops import degrade as jax_degrade
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.convert import discriminator_flax_to_state_dict, flax_to_state_dict
from srganfd_tpu_torch.ops import augment, degrade
from srganfd_tpu_torch.track import tracker
from srganfd_tpu_torch.train import loop
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 16, "growth_channels": 8, "num_rrdb": 1}
BSRGAN = dict(compute_dtype="float64", epochs=2, g_kwargs=TINY_G, d_kwargs={"channels": 8}, content_weight=(),
              gt_image_size=16, skip_nonfinite_updates=True)
BSRNET = dict(compute_dtype="float64", epochs=1, batch_size=2, crop_image_size=48, gt_image_size=16, g_kwargs=TINY_G,
              skip_nonfinite_updates=True)
RAW = 48  # the pre-crop edge
_PORT_INIT = Trainer.init_state  # the run_train comparisons patch it


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The tracker's TensorBoard sink would only add an import of TensorFlow."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_in_f64(jtr, jst):
    g = _f64(jst.g_params)
    out = jst.replace(g_params=g, g_opt_state=jtr.g_tx.init(g), ema_g_params=_f64(jst.ema_g_params))
    if jst.d_params is not None:
        d = _f64(jst.d_params)
        out = out.replace(d_params=d, d_opt_state=jtr.d_tx.init(d), d_vars=_f64(jst.d_vars))
    return out


def _port_from_jax(tr: Trainer, jst):
    """The port's state from the JAX state, in f64 (loaded after the cast:
    x64 JAX draws ``u`` in f64, which an f32 module would round)."""
    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = None
    if jst.d_params is not None:
        d_init = {k: _t(v) for k, v in discriminator_flax_to_state_dict(jst.d_params, jst.d_vars["spectral"]).items()}
    st = _PORT_INIT(tr, init, d_init)
    st.g_model.double().load_state_dict(init)
    st.ema_g = {k: v.double() for k, v in init.items()}
    if d_init is not None:
        st.d_model.double().load_state_dict(d_init)
    return st


# the JAX comparisons' parameters: their LR comes out of an f32 chain (or
# f32 bicubic) in both frameworks, a few ulps apart, and the tensors that are
# small after a few updates (G's biases: 1e-8 - 1e-4) carry that at up to
# 1e-8 of their largest entry (measured, G: 4.37e-9 the fused lockstep,
# 7.18e-9 the fused run, 1.23e-9 the generic run; a bsrgan fused lockstep
# read 9.97e-9 on conv1.bias); the losses hold to 1e-11
PARAM_TOL = 5e-8


def _held(ours: dict, theirs: dict, tol: float = PARAM_TOL) -> float:
    """The largest of each tensor's max abs difference over its largest entry."""
    assert set(ours) == set(theirs)
    worst = 0.0
    for k in theirs:
        got, want = ours[k].detach().numpy(), np.asarray(theirs[k])
        assert got.dtype == want.dtype == np.float64, k
        worst = max(worst, np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert worst <= tol, worst
    return worst


def _plans(seed: int, n_steps: int, batch: int = 2, sf: int = 2, **kw):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        plan = degrade.plan_bsrgan_batch(rng, batch, sf, per_sample_order=True, **kw)
        lim = degrade.bsrgan_lr_size(RAW, plan) - 16 // sf
        out.append((plan, rng.integers(0, lim + 1, batch), rng.integers(0, lim + 1, batch)))
    return out


def _state_tensors(st) -> dict[str, torch.Tensor]:
    out = {f"g.{k}": v for k, v in st.g_model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in st.ema_g.items()})
    if st.d_model is not None:
        out.update({f"d.{k}": v for k, v in st.d_model.state_dict().items()})
    for tag, opt in (("g_opt", st.g_opt), ("d_opt", st.d_opt)):
        if opt is not None:
            for i, s in enumerate(opt.state.values()):
                out.update({f"{tag}.{i}.{k}": v for k, v in s.items()})
    return out


def _bitwise(a, b) -> None:
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb)
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not bad, bad[:5]


# -- the port alone -----------------------------------------------------------


def test_crop_takes_offsets_as_tensors_and_clamps():
    """The chain's aligned crop (a gather, so a graph can hold it) with
    host offsets and with integer tensors against numpy slices, a start
    past the edge and one below 0 clamped."""
    rng = np.random.default_rng(0)
    gt, lr = rng.uniform(size=(3, 40, 40, 3)), rng.uniform(size=(3, 20, 20, 3))
    tops, lefts = np.array([0, 7, 30]), np.array([12, -2, 4])
    t, l = np.clip(tops, 0, 12), np.clip(lefts, 0, 12)
    want_lr = np.stack([lr[i, t[i]:t[i] + 8, l[i]:l[i] + 8] for i in range(3)])
    want_gt = np.stack([gt[i, 2 * t[i]:2 * t[i] + 16, 2 * l[i]:2 * l[i] + 16] for i in range(3)])
    for offsets in ((tops, lefts), (torch.from_numpy(tops), torch.from_numpy(lefts))):
        got_gt, got_lr = augment.paired_random_crop(torch.from_numpy(gt), torch.from_numpy(lr), *offsets, 16, 2)
        assert np.array_equal(got_gt.numpy(), want_gt) and np.array_equal(got_lr.numpy(), want_lr)


@pytest.mark.parametrize("opt_kind", ["adam", "adamw"])
def test_device_adam_equals_torch_adam(opt_kind):
    """``_adam_device`` against ``torch.optim.Adam``/``AdamW`` over 4 f64
    steps at two learning rates; a step with ``finite`` False keeps every
    tensor it would write."""
    torch.manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(5, 3, dtype=torch.float64)) for _ in range(2)]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    kind = torch.optim.AdamW if opt_kind == "adamw" else torch.optim.Adam
    wd = 0.01 if opt_kind == "adamw" else 0.0
    ref, dev = kind(ps, lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd), kind(qs, lr=1e-3, betas=(0.9, 0.99),
                                                                                      eps=1e-8, weight_decay=wd)
    for i, lr in enumerate((1e-3, 1e-3, 5e-4, 5e-4)):
        grads = [torch.randn(5, 3, dtype=torch.float64) for _ in ps]
        for p, q, g in zip(ps, qs, grads):
            p.grad, q.grad = g.clone(), g.clone()
        for group in ref.param_groups:
            group["lr"] = lr
        ref.step()
        loop._adam_device(dev, torch.tensor(lr, dtype=torch.float64), None)
        for p, q in zip(ps, qs):
            torch.testing.assert_close(q, p, rtol=1e-14, atol=1e-16)
    before = {k: v.clone() for k, v in _flat(dev, qs).items()}
    for q in qs:
        q.grad = torch.randn(5, 3, dtype=torch.float64)
    loop._adam_device(dev, torch.tensor(1e-3, dtype=torch.float64), torch.tensor(False))
    assert all(torch.equal(before[k], v) for k, v in _flat(dev, qs).items())
    assert {float(s["step"]) for s in dev.state.values()} == {4.0}


def _flat(opt, params) -> dict[str, torch.Tensor]:
    out = {f"p{i}": p.detach() for i, p in enumerate(params)}
    for i, s in enumerate(opt.state.values()):
        out.update({f"s{i}.{k}": v for k, v in s.items()})
    return out


@pytest.mark.parametrize("name", ["bsrgan", "bsrnet"])
def test_device_form_equals_the_host_form(name):
    """Three steps each way from one state, f64, one step an epoch over two
    epochs (the milestone inside): ``bsrgan`` with the guard,
    accumulation, the clip and AdamW, a NaN in step 1's LR (both phases
    skip); ``bsrnet`` (G only) with the reference EMA's first-step copy.
    The device form's steps equal the host form's to roundoff, the skip
    flags, the counts and Adam's steps exactly."""
    if name == "bsrgan":
        cfg = configs.get_config("bsrgan", **{**BSRGAN, "gt_image_size": 32, "grad_accum_steps": 2,
                                              "grad_clip_norm": 0.05, "model_weight_decay": 0.01})
    else:
        cfg = configs.get_config("bsrnet", compute_dtype="float64", epochs=2, g_kwargs=TINY_G, gt_image_size=32,
                                 ema_reference_semantics=True)
    tr = Trainer(cfg, steps_per_epoch=1)
    size, sf = cfg.gt_image_size, cfg.upscale_factor
    rng = np.random.default_rng(3)
    gts = rng.uniform(size=(3, 4, size, size, 3))
    lrs = np.ascontiguousarray(gts[:, :, ::sf, ::sf])
    if name == "bsrgan":
        lrs[1, 2, 3, 5, 1] = np.nan
    host, dev = (tr.init_state() for _ in range(2))
    for st in (host, dev):
        st.g_model.double()
        st.ema_g = {k: v.double() for k, v in st.ema_g.items()}
        if st.d_model is not None:
            st.d_model.double()
    multi = tr.make_train_multi_step()
    for i in range(3):
        m_host = tr.train_step(host, _t(gts[i]), _t(lrs[i]))
        m_dev = multi(dev, [{"gt": _t(gts[i]), "lr": _t(lrs[i])}])
        assert set(m_dev) == set(m_host)
        for k in m_host:
            np.testing.assert_allclose(float(m_dev[k]), float(m_host[k]), rtol=1e-12, err_msg=k)
    tr.sync_counts(dev)
    assert (dev.step, dev.g_count, dev.d_count) == (host.step, host.g_count, host.d_count)
    if name == "bsrgan":
        assert (host.g_count, host.d_count) == (2, 2)
    ta, tb = _state_tensors(dev), _state_tensors(host)
    for k in tb:
        torch.testing.assert_close(ta[k].cpu().to(tb[k].dtype), tb[k], rtol=1e-12, atol=1e-15, msg=k)


def _raws(seed: int, n_steps: int, batch: int = 2, dtype=np.uint8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n_steps, batch, RAW, RAW, 3)).astype(np.uint8)
    return raw if dtype == np.uint8 else (raw / 255.0).astype(dtype)


def test_fused_step_equals_the_composed_step():
    """The fused dispatch against the adapter's chain and crop followed by
    one step of the same (device) form: bit for bit, two steps."""
    cfg = configs.get_config("bsrgan", **BSRGAN)
    tr = Trainer(cfg, steps_per_epoch=4)
    fused, composed = tr.init_state(), tr.init_state()
    multi = tr.make_train_multi_step()
    raws = _raws(11, 2)
    for raw, (plan, tops, lefts) in zip(raws, _plans(11, 2)):
        m_f = tr.bsrgan_fused_train_step(fused, raw, plan, tops, lefts, 16)
        gt_c, lr_c = degrade.apply_bsrgan_batch_cropped(torch.from_numpy(raw), plan, tops, lefts, 16, 2)
        m_c = multi(composed, [{"gt": gt_c, "lr": lr_c}])
        assert all(torch.equal(m_f[k], m_c[k]) for k in m_c)
    _bitwise(fused, composed)
    assert fused.step == 2


def test_fused_multi_step_equals_sequential_fused_steps():
    """K = 3 fused steps of one branch key in one dispatch against three
    single fused dispatches: the state bit for bit, the metrics their mean.
    A dispatch of plans of two branch keys raises."""
    cfg = configs.get_config("bsrgan", **{**BSRGAN, "compute_dtype": "float32"})
    tr = Trainer(cfg, steps_per_epoch=4)
    seq, multi = tr.init_state(), tr.init_state()
    raws, plans = _raws(13, 3), _plans(13, 3)
    ms = [tr.bsrgan_fused_train_step(seq, raw, p, t, l, 16) for raw, (p, t, l) in zip(raws, plans)]
    m = tr.bsrgan_fused_train_multi_step(multi, list(raws), *map(list, zip(*plans)), 16)
    _bitwise(seq, multi)
    assert seq.step == multi.step == 3
    for k in m:
        assert torch.equal(m[k], torch.stack([x[k] for x in ms]).mean(0)), k
    x4 = _plans(5, 8, sf=4, scale2_prob=0.5)
    keys = {(p.scale2, p.scale2_interp, p.effective_upscale) for p, _, _ in x4}
    assert len(keys) > 1
    with pytest.raises(ValueError, match="static branch"):
        Trainer(configs.get_config("bsrgan", **{**BSRGAN, "upscale_factor": 4})).bsrgan_fused_train_multi_step(
            multi, [raws[0]] * 8, *map(list, zip(*x4)), 16)


def test_generic_multi_step_equals_sequential_steps():
    """``make_train_multi_step(separate_pixel_target=True)``: two steps with
    a pixel target apart from D's real input, in one dispatch against two
    single dispatches, bit for bit; the metrics their mean."""
    cfg = configs.get_config("bsrgan", **{**BSRGAN, "compute_dtype": "float32"})
    tr = Trainer(cfg, steps_per_epoch=4)
    seq, multi = tr.init_state(), tr.init_state()
    rng = np.random.default_rng(4)
    batches = [{k: torch.from_numpy(rng.uniform(size=(2, 16 // s, 16 // s, 3)).astype(np.float32))
                for k, s in (("gt", 1), ("gt_pixel", 1), ("lr", 2))} for _ in range(2)]
    step = tr.make_train_multi_step(separate_pixel_target=True)
    ms = [step(seq, [b]) for b in batches]
    m = step(multi, batches)
    _bitwise(seq, multi)
    for k in m:
        assert torch.equal(m[k], torch.stack([x[k] for x in ms]).mean(0)), k


def _jpeg_free_plan(plan):
    """The plan with its JPEG stages masked off (the draws unchanged)."""
    return dataclasses.replace(plan, jpeg_apply=np.zeros_like(plan.jpeg_apply),
                               final_jpeg_quality=np.zeros_like(plan.final_jpeg_quality))


def test_fused_steps_lockstep_with_jax():
    """``bsrnet`` (the guard on; the config and the five steps an epoch of
    the fused ``run_train`` comparison below, whose programs this compiles
    for JAX's cache): steps 0 and 1 as one K = 2 fused dispatch, step 2 as
    a single one, from one converted f64 state on uint8 frames with
    JPEG-free plans. The losses (a dispatch's mean) to 1e-9, G and EMA-G to
    ``PARAM_TOL``, the counts exactly."""
    jcfg = jax_configs.get_config("bsrnet", **BSRNET)
    jtr = JaxTrainer(jcfg, steps_per_epoch=5)
    jst = _jax_in_f64(jtr, jtr.init_state(jax.random.PRNGKey(0), (2, 8, 8, 3), (2, 16, 16, 3)))
    tr = Trainer(configs.get_config("bsrnet", **BSRNET), steps_per_epoch=5)
    st = _port_from_jax(tr, jst)
    raws = _raws(21, 3)
    steps = [(_jpeg_free_plan(p), t, l) for p, t, l in _plans(21, 3)]
    jplans = [jax_degrade.BsrganPlan(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)}) for p, _, _ in steps]
    keys = ("pixel_loss", "g_loss", "g_update_skipped")
    jst, jm = jtr.bsrgan_fused_train_multi_step(jst, list(raws[:2]), jplans[:2], [t for _, t, _ in steps[:2]],
                                                [l for _, _, l in steps[:2]], 16)
    m = tr.bsrgan_fused_train_multi_step(st, list(raws[:2]), *map(list, zip(*steps[:2])), 16)
    jst, jm1 = jtr.bsrgan_fused_train_step(jst, jnp.asarray(raws[2]), jplans[2], steps[2][1], steps[2][2], 16)
    m1 = tr.bsrgan_fused_train_step(st, raws[2], *steps[2], 16)
    for ours, theirs in ((m, jm), (m1, jm1)):
        assert set(ours) == set(keys)
        np.testing.assert_allclose([float(ours[k]) for k in keys], [float(theirs[k]) for k in keys], rtol=1e-9)
    tr.sync_counts(st)
    assert (st.step, st.g_count, st.d_count) == (3, 3, 0)
    _held(st.g_model.state_dict(), flax_to_state_dict(jst.g_params))
    _held(st.ema_g, flax_to_state_dict(jst.ema_g_params))


# -- cli.train under the dispatch variables, against the JAX CLI --------------------


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:56, 0:56] / 56
    for i in range(8):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2)))
        img = np.clip(base[..., None] + 0.1 * rng.standard_normal((56, 56, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"frame_{i}.png"), (img * 255).astype(np.uint8))
    return str(d)


def _jpeg_free(real):
    return lambda *args, **kw: _jpeg_free_plan(real(*args, **kw))


def _run_both(monkeypatch, tmp_path, name: str, env: dict, **over):
    """JAX's ``run_train`` and the port's on one config from one f64 state
    (the JAX one, converted), 1 epoch of 5 steps; returns both states."""
    for k, v in {"SRGANFD_NATIVE_LOADER": "1", **env}.items():
        monkeypatch.setenv(k, v)
    over = {"epochs": 1, "batch_size": 2, "compute_dtype": "float64", **over}
    seen = {}
    real_init = JaxTrainer.init_state

    def jax_init(self, *a, **kw):
        state = _jax_in_f64(self, real_init(self, *a, **kw))
        seen["state"] = jax.device_get(state)  # the run donates its state
        return state

    monkeypatch.setattr(JaxTrainer, "init_state", jax_init)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_cli_train.run_train(jax_configs.get_config(name, **over), steps_per_epoch=5, use_mesh=False)["state"]
    monkeypatch.setattr(Trainer, "init_state", lambda self, *a, **kw: _port_from_jax(self, seen["state"]))
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = cli_train.run_train(configs.get_config(name, **over), steps_per_epoch=5, device="cpu")["state"]
    return want, got


def test_run_train_fused_kstep_matches_jax(frames, tmp_path, monkeypatch, capsys):
    """``bsrnet`` under ``SRGANFD_FUSE_STEP=1 SRGANFD_STEPS_PER_DISPATCH=2``:
    two K = 2 dispatches and the fifth step flushed alone at the epoch's
    end, on the native loader's uint8 crops; G and EMA-G to ``PARAM_TOL``."""
    monkeypatch.setattr(jax_degrade, "plan_bsrgan_batch", _jpeg_free(jax_degrade.plan_bsrgan_batch))
    monkeypatch.setattr(cli_train, "plan_bsrgan_batch", _jpeg_free(cli_train.plan_bsrgan_batch))
    want, got = _run_both(monkeypatch, tmp_path, "bsrnet",
                          {"SRGANFD_FUSE_STEP": "1", "SRGANFD_STEPS_PER_DISPATCH": "2"},
                          train_gt_images_dir=frames, valid_gt_images_dir=frames, **BSRNET)
    out = capsys.readouterr().out
    assert out.count("using native C++ data loader") == 2
    assert out.count("K-step dispatch: 2 train steps per device dispatch (fused chain)") == 2
    assert got.step == 5 and (got.g_count, got.d_count) == (5, 0)
    _held(got.g_model.state_dict(), flax_to_state_dict(want.g_params))
    _held(got.ema_g, flax_to_state_dict(want.ema_g_params))


def test_run_train_generic_kstep_matches_jax(frames, tmp_path, monkeypatch, capsys):
    """``rrdbnet`` (bicubic LR) under ``SRGANFD_STEPS_PER_DISPATCH=2``: the
    generic form on the adapter's batches, the fifth step flushed alone;
    G and EMA-G to ``PARAM_TOL``."""
    want, got = _run_both(monkeypatch, tmp_path, "rrdbnet", {"SRGANFD_STEPS_PER_DISPATCH": "2"},
                          train_gt_images_dir=frames, valid_gt_images_dir=frames, gt_image_size=32,
                          g_kwargs={"channels": 16, "growth_channels": 8, "num_blocks": 1})
    out = capsys.readouterr().out
    assert out.count("K-step dispatch: 2 train steps per device dispatch\n") == 2
    assert got.step == 5 and got.g_count == 5
    _held(got.g_model.state_dict(), flax_to_state_dict(want.g_params))
    _held(got.ema_g, flax_to_state_dict(want.ema_g_params))


def test_fused_kstep_resume_is_step_exact(frames, tmp_path, monkeypatch):
    """Under fused K = 2 dispatch with ``save_every_steps=3`` the buffers are
    flushed before the step snapshot (it holds step 4); a run that stops
    right after it and resumes ends bit for bit where the uninterrupted run
    ends."""
    monkeypatch.setenv("SRGANFD_FUSE_STEP", "1")
    monkeypatch.setenv("SRGANFD_STEPS_PER_DISPATCH", "2")

    def cfg():
        return configs.get_config("bsrnet", train_gt_images_dir=frames, valid_gt_images_dir=frames, epochs=1,
                                  batch_size=2, crop_image_size=48, gt_image_size=16, g_kwargs=TINY_G)

    (tmp_path / "a").mkdir()
    monkeypatch.chdir(tmp_path / "a")
    want = cli_train.run_train(cfg(), steps_per_epoch=6, save_every_steps=3, device="cpu")["state"]

    (tmp_path / "b").mkdir()
    monkeypatch.chdir(tmp_path / "b")
    real_save = cli_train.ckpt.save_checkpoint

    def stop_after_step_snapshot(*args, **kw):
        real_save(*args, **kw)
        if kw.get("name") == "ckpt_step":
            raise KeyboardInterrupt

    monkeypatch.setattr(cli_train.ckpt, "save_checkpoint", stop_after_step_snapshot)
    with pytest.raises(KeyboardInterrupt):
        cli_train.run_train(cfg(), steps_per_epoch=6, save_every_steps=3, device="cpu")
    monkeypatch.setattr(cli_train.ckpt, "save_checkpoint", real_save)
    snap = tmp_path / "b" / "results" / "BSRNet_x2" / "ckpt_step_last.pth"
    assert torch.load(snap, weights_only=False)["step"] == 4
    got = cli_train.run_train(cfg(), steps_per_epoch=6, save_every_steps=3, resume=str(snap), device="cpu")["state"]
    _bitwise(want, got)

