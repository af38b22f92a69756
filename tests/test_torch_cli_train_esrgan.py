"""The two-stage recipes on the CPU through ``cli.train``: ``--config
rrdbnet`` then ``--config esrgan --pretrained-g`` (at full G width, so
that ``cli.infer`` serves the ``esrgan`` checkpoint), ``bsrnet`` then
``bsrgan`` and ``realesrnet`` then ``realesrgan`` with the pretrained G,
``--pretrained-d`` between GAN runs, a ``--resume`` that overrides a
graft, grafts across archs by name and shape, and the graft sources that
are not ported. Seeded synthetic frames of 136 x 136; one step per run;
G at ``--tiny`` widths (8 channels, growth 4, 1 RRDB) and D at 8 channels
where the test does not need the configs' widths.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli import infer
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.track import tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY = {"channels": 8, "growth_channels": 4}
EXP = {"rrdbnet": "train_RRDBNet_x4", "esrgan": "train_ESRGAN_x4_bubbles", "bsrnet": "BSRNet_x2",
       "bsrgan": "BSRGAN_x2", "realesrnet": "RealESRNet_x4", "realesrgan": "RealESRGAN_x4"}
D_KW = {"esrgan": {"channels": 8}, "bsrgan": {"channels": 8}, "realesrgan": {"channels": 8}}
GT = {"rrdbnet": 32, "esrgan": 128, "bsrnet": 32, "bsrgan": 32, "realesrnet": 64, "realesrgan": 64}


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The TensorBoard sink, where it is installed, would only add an import
    of TensorFlow."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:136, 0:136] / 136
    for i in range(2):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 2) + yy * rng.uniform(0.5, 2))) + 0.1 * (xx > 0.5)
        img = np.clip(base[..., None] + 0.05 * rng.standard_normal((136, 136, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"frame_{i}.png"), (img * 255).astype(np.uint8))
    return str(d)


@pytest.fixture()
def first_step(monkeypatch):
    """Records each run's state as its first ``train_step`` finds it: G,
    EMA-G, D (buffers included) and how many parameters each Adam holds a
    state for."""
    seen = []
    real = Trainer.train_step

    def recorded(self, state, *a, **kw):
        if not seen or seen[-1]["step_of_run"] != id(state):
            seen.append({
                "step_of_run": id(state), "step": state.step,
                "g": {k: v.detach().clone() for k, v in state.g_model.state_dict().items()},
                "ema": {k: v.clone() for k, v in state.ema_g.items()},
                "d": None if state.d_model is None else {k: v.clone() for k, v in state.d_model.state_dict().items()},
                "adam_states": (len(state.g_opt.state), 0 if state.d_opt is None else len(state.d_opt.state)),
            })
        return real(self, state, *a, **kw)

    monkeypatch.setattr(Trainer, "train_step", recorded)
    return seen


def _cfg(name, frames, root, **over):
    """``name``'s config on the frames, one step per epoch, G tiny and D at 8
    channels unless ``over`` says otherwise."""
    kw = dict(train_gt_images_dir=frames, valid_gt_images_dir=frames, gt_image_size=GT[name], crop_image_size=0,
              batch_size=2, epochs=1, num_workers=1, results_dir=os.path.join(root, "results"),
              samples_dir=os.path.join(root, "samples"))
    cfg = configs.get_config(name, **kw)
    count = "num_blocks" if cfg.g_arch.startswith("rrdbnet_x") else "num_rrdb"
    cfg = cfg.replace(g_kwargs={**TINY, count: 1}, d_kwargs=D_KW.get(name, {}))
    return cfg.replace(**over)


def _last(root, name):
    return os.path.join(root, "results", EXP[name], "ckpt_last.pth")


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_rrdbnet_then_esrgan_with_pretrained_g_and_infer(frames, tmp_path, monkeypatch, capsys, first_step):
    """Full-width ``rrdbnet_x4`` (64/32/23): ``--config rrdbnet`` for one
    step at GT 32, then ``--config esrgan --pretrained-g`` its
    ``ckpt_last.pth`` for one step at GT 128 (the VGG-128 D at 8 channels
    through ``run_train``, which the flag reaches as the config field):
    the esrgan run's G and EMA-G at step 0 are the file's ``state_dict``,
    all 702 tensors, its Adams fresh; ``cli.infer --use-ema`` serves
    the esrgan checkpoint."""
    monkeypatch.chdir(tmp_path)
    cli_train.main(["--config", "rrdbnet", "--device-type", "cpu", "--train-dir", frames, "--valid-dir", frames,
                    "--gt-size", "32", "--batch-size", "1", "--steps-per-epoch", "1", "--epochs", "1"])
    source = ckpt.load_checkpoint(_last(tmp_path, "rrdbnet"))["state_dict"]
    assert len(source) == 2 * (69 * 5 + 5) + 2  # conv1, trunk, conv2, 2 upsamplings, conv3, conv4
    capsys.readouterr()
    cfg = _cfg("esrgan", frames, str(tmp_path), batch_size=1, g_kwargs={},
               pretrained_g_model_weights_path=_last(tmp_path, "rrdbnet"))
    monkeypatch.setattr(configs, "get_config", lambda name, **kw: cfg.replace(**{
        k: v for k, v in kw.items() if k in ("pretrained_g_model_weights_path", "pretrained_d_model_weights_path")}))
    cli_train.main(["--config", "esrgan", "--device-type", "cpu", "--pretrained-g", _last(tmp_path, "rrdbnet"),
                    "--steps-per-epoch", "1"])
    assert f"loaded pretrained G ({len(source)}/{len(source)} tensors) from {_last(tmp_path, 'rrdbnet')}" in \
        capsys.readouterr().out
    start = first_step[-1]
    assert start["step"] == 0 and start["adam_states"] == (0, 0)
    assert _same(start["g"], source) and _same(start["ema"], source)
    out = ckpt.load_checkpoint(_last(tmp_path, "esrgan"))
    assert out["step"] == 1 and set(out["d_state_dict"]) >= {"features.3.running_mean", "classifier.0.weight"}

    png = tmp_path / "sr.png"
    cv2.imwrite(str(tmp_path / "lr.png"), cv2.imread(os.path.join(frames, "frame_0.png"))[:16, :20])
    infer.main(["--device-type", "cpu", "--model-arch", "rrdbnet_x4", "--weights", _last(tmp_path, "esrgan"),
                "--use-ema", "--inputs-path", str(tmp_path / "lr.png"), "--output-path", str(png)])
    assert cv2.imread(str(png)).shape == (64, 80, 3)


@pytest.mark.parametrize("chain", [("bsrnet", "bsrgan"), ("realesrnet", "realesrgan"), ("rrdbnet", "esrgan")],
                         ids=lambda c: f"{c[0]}_to_{c[1]}")
def test_gan_stage_starts_from_the_l1_stage(chain, frames, tmp_path, capsys, first_step):
    """Each recipe's GAN stage with ``pretrained_g_model_weights_path`` on
    its L1 stage's ``ckpt_last.pth``: G and EMA-G at step 0 equal the
    file's raw G (not its EMA-G, as the JAX graft takes ``g_params``), the
    line says n/n tensors, D keeps its seeded init and both Adams start
    empty."""
    l1, gan = chain
    cli_train.run_train(_cfg(l1, frames, str(tmp_path)), 1, device="cpu")
    saved = ckpt.load_checkpoint(_last(tmp_path, l1))
    assert not _same(saved["state_dict"], saved["ema_state_dict"])
    capsys.readouterr()
    cfg = _cfg(gan, frames, str(tmp_path), pretrained_g_model_weights_path=_last(tmp_path, l1))
    cli_train.run_train(cfg, 1, device="cpu")
    n = len(saved["state_dict"])
    assert f"loaded pretrained G ({n}/{n} tensors)" in capsys.readouterr().out
    start = first_step[-1]
    assert _same(start["g"], saved["state_dict"]) and _same(start["ema"], saved["state_dict"])
    assert start["adam_states"] == (0, 0)
    seeded = Trainer(cfg.replace(pretrained_g_model_weights_path=""), 1).init_state()
    assert _same(start["d"], seeded.d_model.state_dict())


@pytest.mark.parametrize("name", ["bsrgan", "esrgan"])
def test_pretrained_d_brings_u_or_running_statistics(name, frames, tmp_path, capsys, first_step):
    """A GAN run, then a one-step run with ``pretrained_d_model_weights_path``
    on its checkpoint: D at step 0 is the file's ``d_state_dict``, the
    spectral-norm ``u`` (``bsrgan``) or the BatchNorm running statistics
    (``esrgan``) included, D's Adam fresh, G the seeded init."""
    cli_train.run_train(_cfg(name, frames, str(tmp_path)), 1, device="cpu")
    saved = ckpt.load_checkpoint(_last(tmp_path, name))["d_state_dict"]
    state_keys = [k for k in saved if k.endswith((".u", ".running_mean", ".running_var"))]
    assert len(state_keys) == (8 if name == "bsrgan" else 18)
    capsys.readouterr()
    cfg = _cfg(name, frames, str(tmp_path / "again"), pretrained_d_model_weights_path=_last(tmp_path, name))
    cli_train.run_train(cfg, 1, device="cpu")
    n = len(saved)
    assert f"loaded pretrained D ({n}/{n} tensors)" in capsys.readouterr().out
    start = first_step[-1]
    assert _same(start["d"], saved) and start["adam_states"] == (0, 0)
    seeded = Trainer(cfg, 1).init_state()
    assert _same(start["g"], seeded.g_model.state_dict())
    # a D that moved from its init: the graft is not the seeded D again
    assert any(not torch.equal(saved[k], v) for k, v in seeded.d_model.state_dict().items())


def test_pretrained_d_without_a_discriminator_is_ignored(frames, tmp_path, capsys, first_step):
    """As in JAX: the L1 configs have no D to graft into."""
    cli_train.run_train(_cfg("bsrgan", frames, str(tmp_path)), 1, device="cpu")
    capsys.readouterr()
    cli_train.run_train(_cfg("bsrnet", frames, str(tmp_path), pretrained_d_model_weights_path=_last(tmp_path, "bsrgan")),
                        1, device="cpu")
    assert "pretrained D" not in capsys.readouterr().out and first_step[-1]["d"] is None


def test_resume_overrides_the_graft(frames, tmp_path, first_step):
    """``bsrgan`` grafted from ``bsrnet`` for an epoch, then the same command
    line with ``--resume auto`` for a second: the graft runs again, and the
    restore after it puts back the checkpoint's G, EMA-G, D and step."""
    cli_train.run_train(_cfg("bsrnet", frames, str(tmp_path)), 1, device="cpu")
    cfg = _cfg("bsrgan", frames, str(tmp_path), pretrained_g_model_weights_path=_last(tmp_path, "bsrnet"))
    cli_train.run_train(cfg, 1, device="cpu")
    mid = ckpt.load_checkpoint(_last(tmp_path, "bsrgan"))
    cli_train.run_train(cfg.replace(epochs=2), 1, resume="auto", device="cpu")
    start = first_step[-1]
    assert start["step"] == 1
    assert _same(start["g"], mid["state_dict"]) and _same(start["ema"], mid["ema_state_dict"])
    assert _same(start["d"], mid["d_state_dict"])
    assert not _same(start["g"], ckpt.load_checkpoint(_last(tmp_path, "bsrnet"))["state_dict"])


def test_a_graft_across_archs_takes_what_matches_by_name_and_shape(frames, tmp_path, capsys):
    """``rrdbnet_x4``'s G into other generators, as the reference's
    pretrained load does (``ESRGAN/utils.py:68-77``: a tensor whose name is
    in the model with its shape): into ``bsrgan_x2`` every tensor has its
    name and shape there (conv1, trunk, conv2, upsampling1, conv3, conv4;
    ``upsampling2`` has no place and is ignored); into ``bsrgantrans_x2``
    the trunk and the convs around it, its transformer bottleneck keeping
    its init; into a ``bsrgan_x2`` of growth 8 only the convs whose shapes
    the growth does not change. n_ok < n_all in the last two."""
    cli_train.run_train(_cfg("rrdbnet", frames, str(tmp_path)), 1, device="cpu")
    source = ckpt.load_checkpoint(_last(tmp_path, "rrdbnet"))["state_dict"]
    for name, over in (("bsrnet", {}), ("aesrgan", {"g_kwargs": {**TINY, "num_rrdb": 1}}),
                       ("bsrnet", {"g_kwargs": {"channels": 8, "growth_channels": 8, "num_rrdb": 1}})):
        cfg = configs.get_config(name, **over) if over else _cfg(name, frames, str(tmp_path))
        cfg = cfg.replace(pretrained_g_model_weights_path=_last(tmp_path, "rrdbnet"))
        state = Trainer(cfg, 1).init_state()
        init = {k: v.clone() for k, v in state.g_model.state_dict().items()}
        capsys.readouterr()
        cli_train.graft_pretrained(cfg, state)
        n_ok, n_all = (int(v) for v in capsys.readouterr().out.split("(")[1].split(" ")[0].split("/"))
        got = state.g_model.state_dict()
        taken = {k for k in got if k in source and source[k].shape == got[k].shape}
        assert n_ok == len(taken) and n_all == len(got)
        assert all(torch.equal(got[k], source[k]) for k in taken)
        assert all(torch.equal(got[k], init[k]) for k in set(got) - taken)
        assert all(torch.equal(state.ema_g[k], got[k]) for k in state.ema_g)
        if cfg.g_arch == "bsrgantrans_x2":
            assert n_ok < n_all and all(k.startswith(("transformer.", "down_conv", "up_conv"))
                                        for k in set(got) - taken)
            assert "trunk.0.rdb1.conv1.weight" in taken
        elif cfg.g_kwargs.get("growth_channels") == 8:
            assert n_ok < n_all and "trunk.0.rdb1.conv1.weight" not in taken and "conv1.weight" in taken
        else:
            assert n_ok == n_all and "upsampling2.0.weight" in source


@pytest.mark.parametrize("source", ["g.npz", "runs:/0123/best_g_model"])
def test_graft_sources_that_are_not_ported_name_the_roadmap_item(frames, source, tmp_path, monkeypatch, capsys,
                                                                 first_step):
    """The JAX graft's two other sources, now ported: a ``.npz`` of Flax
    paths (the bridge's inverse of a tiny ``bsrgan_x2``) and an MLflow
    ``runs:/`` URI resolved in a ``file:`` store (its artifact a
    reference-layout file). ``--pretrained-g`` from each grafts every
    tensor: G and EMA-G at step 0 are the source's."""
    from srganfd_tpu_torch.convert import flatten_flax, state_dict_to_flax

    monkeypatch.chdir(tmp_path)
    model = create_model("bsrgan_x2", **TINY, num_rrdb=1)
    sd = {k: v + 1 for k, v in model.state_dict().items()}
    if source.endswith(".npz"):
        np.savez(tmp_path / source, **flatten_flax(state_dict_to_flax(sd, 1)))
    else:
        store = tmp_path / "store"
        (store / "0" / "0123" / "artifacts").mkdir(parents=True)
        torch.save({"state_dict": sd}, store / "0" / "0123" / "artifacts" / "best_g_model")
        monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{store}")
    cli_train.main(["--config", "bsrnet", "--device-type", "cpu", "--tiny", "--train-dir", frames,
                    "--valid-dir", frames, "--gt-size", "32", "--batch-size", "1", "--steps-per-epoch", "1",
                    "--epochs", "1", "--pretrained-g", source])
    assert f"loaded pretrained G ({len(sd)}/{len(sd)} tensors) from {source}" in capsys.readouterr().out
    assert _same(first_step[0]["g"], sd) and _same(first_step[0]["ema"], sd)


def test_a_reference_layout_file_grafts(frames, tmp_path):
    """A ``.pth.tar`` as the reference writes it (``ESRGAN/utils.py:30-101``:
    ``{"state_dict": ..., "epoch": ...}``, one model a file) serves
    ``--pretrained-g`` and ``--pretrained-d``; a port checkpoint without
    the D that ``--pretrained-d`` asks for raises."""
    cfg = _cfg("bsrgan", frames, str(tmp_path))
    state = Trainer(cfg, 1).init_state()
    g, d = state.g_model.state_dict(), state.d_model.state_dict()
    torch.save({"epoch": 3, "best_psnr": 20.0, "state_dict": {k: v + 1 for k, v in g.items()}}, tmp_path / "g.pth.tar")
    torch.save({"epoch": 3, "state_dict": {k: v + 1 for k, v in d.items()}}, tmp_path / "d.pth.tar")
    assert _same(ckpt.load_pretrained(str(tmp_path / "g.pth.tar")), {k: v + 1 for k, v in g.items()})
    assert _same(ckpt.load_pretrained(str(tmp_path / "d.pth.tar"), "d_state_dict"), {k: v + 1 for k, v in d.items()})
    cli_train.run_train(_cfg("bsrnet", frames, str(tmp_path)), 1, device="cpu")
    with pytest.raises(KeyError, match="d_state_dict"):
        ckpt.load_pretrained(_last(tmp_path, "bsrnet"), "d_state_dict")
