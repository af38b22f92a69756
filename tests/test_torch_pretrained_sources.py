"""The graft's other sources on the CPU: a ``.npz`` in
``tools/port_torch_weights.py``'s layout and an MLflow ``runs:/`` URI,
against the JAX package's ``load_pretrained_params``, ``merge_by_path``
and ``resolve_checkpoint_uri`` (tiny widths: 16 channels, growth 8, 2
RRDBs; the VGG-128 D at 8 channels)."""

import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.train import checkpoint as jax_ckpt
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.train import checkpoint as ckpt
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
import port_torch_weights as port  # noqa: E402

TINY = {"channels": 16, "growth_channels": 8}


def _tiny(arch):
    return {**TINY, ("num_blocks" if arch.startswith("rrdbnet") else "num_rrdb"): 2}


def _spread(model, seed):
    """Weights drawn from a numpy seed (N(0, 1/fan_in), biases N(0, 0.1),
    0.5 on the last bias), so that outputs spread over [0, 1]."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if v.dim() == 4:
            sd[k] = torch.from_numpy((rng.normal(size=v.shape) / np.sqrt(v[0].numel())).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((rng.normal(size=v.shape) * 0.1).astype(np.float32))
    sd["conv4.bias"] = sd["conv4.bias"] + 0.5
    return sd


def _reference_npz(tmp_path, arch, seed):
    """A reference-layout ``.pth.tar`` of the tiny ``arch`` converted by
    ``tools/port_torch_weights.py`` as its ``main`` does; returns the npz
    path and the state dict."""
    sd = _spread(create_model(arch, **_tiny(arch)), seed)
    torch.save({"epoch": 3, "state_dict": sd}, tmp_path / f"{arch}.pth.tar")
    params = port.convert_rrdb_generator(port.load_torch_state_dict(str(tmp_path / f"{arch}.pth.tar")), 2)
    path = str(tmp_path / f"{arch}.npz")
    np.savez(path, **port.flatten(params))
    return path, sd


def _jax_graft(arch, path, x):
    """The JAX trainer's G graft: ``load_pretrained_params`` merged into a
    fresh init by Flax path and shape; returns (n_ok, n_all, output)."""
    model = create_flax(arch, **_tiny(arch))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    merged, n_ok, n_all = jax_ckpt.merge_by_path(params, jax_ckpt.load_pretrained_params(path, "g_params"))
    return n_ok, n_all, np.asarray(jax.jit(model.apply)({"params": merged}, jnp.asarray(x)))


def _port_graft(arch, path, x):
    model = create_model(arch, **_tiny(arch))
    n_ok, n_all = ckpt.merge_by_path(model, ckpt.load_pretrained(path, "state_dict", model))
    with torch.inference_mode():
        return n_ok, n_all, model.eval()(torch.from_numpy(x)).numpy(), model


def test_npz_graft_of_a_ported_reference_file_matches_jax(tmp_path):
    """Same arch: every tensor lands in both, and the two G agree to 1e-6."""
    path, sd = _reference_npz(tmp_path, "rrdbnet_x4", 0)
    x = np.random.default_rng(1).uniform(size=(1, 10, 12, 3)).astype(np.float32)
    j_ok, j_all, want = _jax_graft("rrdbnet_x4", path, x)
    p_ok, p_all, got, model = _port_graft("rrdbnet_x4", path, x)
    err = float(np.abs(got - want).max())
    print(f"npz graft: JAX {j_ok}/{j_all}, port {p_ok}/{p_all}; G max abs {err:.3g}")
    assert (p_ok, p_all) == (j_ok, j_all) and p_ok == p_all
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    assert err <= 1e-6


def test_npz_graft_through_cli_train_prints_the_count(tmp_path, monkeypatch, capsys):
    """``--pretrained-g`` of the npz in ``run_train``'s graft: G and EMA-G
    are the file's."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli.train import graft_pretrained
    from srganfd_tpu_torch.train.loop import Trainer

    path, sd = _reference_npz(tmp_path, "bsrgan_x2", 2)
    cfg = configs.get_config("bsrnet", g_kwargs=_tiny("bsrgan_x2"), pretrained_g_model_weights_path=path)
    state = Trainer(cfg, 1).init_state()
    graft_pretrained(cfg, state)
    n = len(sd)
    assert f"loaded pretrained G ({n}/{n} tensors) from {path}" in capsys.readouterr().out
    assert all(torch.equal(state.g_model.state_dict()[k], v) and torch.equal(state.ema_g[k], v)
               for k, v in sd.items())


def test_vgg128_discriminator_npz_lands_its_running_statistics(tmp_path):
    d = create_model("discriminator", channels=8)
    rng = np.random.default_rng(3)
    sd = {k: torch.from_numpy(rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32))
          for k, v in d.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "d.pth.tar")
    params, stats = port.convert_vgg_discriminator(port.load_torch_state_dict(str(tmp_path / "d.pth.tar")))
    np.savez(tmp_path / "d.npz", **port.flatten(dict(params, batch_stats=stats)))
    target = create_model("discriminator", channels=8)
    n_ok, n_all = ckpt.merge_by_path(target, ckpt.load_pretrained(str(tmp_path / "d.npz"), "d_state_dict", target))
    got = target.state_dict()
    assert n_ok == n_all == len(sd)
    stat_keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 18 and all(torch.equal(got[k], sd[k]) for k in stat_keys)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_unet_discriminator_npz_keeps_the_init_u(tmp_path):
    """A ``discriminator_unet`` npz carries no spectral collection: the
    weights land and every ``u`` keeps its init, as in the JAX graft
    (``u`` lives in ``d_vars``, which the npz does not hold)."""
    d = create_model("discriminator_unet", channels=8)
    sd = {k: v + 1 for k, v in d.state_dict().items()}
    hwio = lambda name: sd[f"{name}.weight"].permute(2, 3, 1, 0).numpy()  # noqa: E731
    flax = {"Conv_0": {"Conv_0": {"kernel": hwio("conv0"), "bias": sd["conv0.bias"].numpy()}},
            "Conv_1": {"Conv_0": {"kernel": hwio("conv9"), "bias": sd["conv9.bias"].numpy()}}}
    for i in range(8):
        flax[f"SNConv_{i}"] = {"kernel": hwio(f"conv{i + 1}")}
    np.savez(tmp_path / "d.npz", **port.flatten(flax))
    target = create_model("discriminator_unet", channels=8)
    init_u = {k: v.clone() for k, v in target.state_dict().items() if k.endswith(".u")}
    n_ok, n_all = ckpt.merge_by_path(target, ckpt.load_pretrained(str(tmp_path / "d.npz"), "d_state_dict", target))
    assert n_ok == n_all - len(init_u) and len(init_u) == 8
    got = target.state_dict()
    assert all(torch.equal(got[k], init_u[k]) for k in init_u)
    assert all(torch.equal(got[k], sd[k]) for k in sd if k not in init_u)


def test_cross_arch_npz_takes_what_the_target_family_bridge_names(tmp_path):
    """The rule the port pins: a generator ``.npz`` maps through the bridge
    of its OWN family, chosen from the tree's keys (``flax_to_state_dict``,
    as every ``.npz`` read of the port), and ``merge_by_path`` then takes
    what matches by name and shape, as for a ``.pth`` across archs. A
    ``bsrgan_x2`` tree into ``rrdbnet_x4`` takes all but
    ``upsampling2.0``, which x2 lacks. The JAX graft merges by Flax's
    positional names instead: its ``Conv_3`` (x2's conv3) lands in x4's
    ``Conv_3`` (upsampling2), and ``Conv_4``/``Conv_5`` miss, so it takes
    two tensors fewer. A ``bsrgantrans_x2`` tree into ``rrdbnet_x4`` takes
    the tensors the two nets share by name and shape; the transformer's
    have no place."""
    path, sd = _reference_npz(tmp_path, "bsrgan_x2", 4)
    x = np.random.default_rng(5).uniform(size=(1, 8, 8, 3)).astype(np.float32)
    j_ok, j_all, _ = _jax_graft("rrdbnet_x4", path, x)
    p_ok, p_all, _, model = _port_graft("rrdbnet_x4", path, x)
    print(f"bsrgan_x2 npz into rrdbnet_x4: port {p_ok}/{p_all}, JAX {j_ok}/{j_all}")
    assert p_all == j_all and p_ok == p_all - 2 and j_ok == j_all - 4
    got = model.state_dict()
    assert torch.equal(got["conv3.0.weight"], sd["conv3.0.weight"]) and torch.equal(got["conv4.bias"], sd["conv4.bias"])

    from srganfd_tpu_torch.convert import flatten_flax, state_dict_to_flax

    trans = _spread(create_model("bsrgantrans_x2", **_tiny("bsrgantrans_x2")), 6)
    np.savez(tmp_path / "trans.npz", **flatten_flax(state_dict_to_flax(trans, 2)))
    target = create_model("rrdbnet_x4", **_tiny("rrdbnet_x4"))
    init = {k: v.clone() for k, v in target.state_dict().items()}
    shared = {k for k, v in init.items() if k in trans and trans[k].shape == v.shape}
    n_ok, n_all = ckpt.merge_by_path(target, ckpt.load_pretrained(str(tmp_path / "trans.npz"), "state_dict", target))
    print(f"bsrgantrans_x2 npz into rrdbnet_x4: port {n_ok}/{n_all}, {len(trans)} tensors in the file")
    assert n_ok == len(shared) and 0 < n_ok < min(n_all, len(trans))
    got = target.state_dict()
    assert all(torch.equal(got[k], trans[k] if k in shared else init[k]) for k in got)


def test_npz_source_needs_the_target_model(tmp_path):
    path, _ = _reference_npz(tmp_path, "rrdbnet_x4", 6)
    with pytest.raises(ValueError, match="pass the model"):
        ckpt.load_pretrained(path)


def _mlruns(root, run_id="0123abcd", artifact="best_g_model.npz", experiments=("7", "3")):
    for exp in experiments:
        d = root / exp / run_id / "artifacts"
        d.mkdir(parents=True)
        (d / artifact).write_bytes(b"x")
    return run_id, artifact


@pytest.mark.parametrize("form", ["file://", "file:", "", "cwd"])
def test_resolve_checkpoint_uri_matches_jax(tmp_path, monkeypatch, form):
    """The same ``mlruns`` layout (two experiments holding the run: the
    first sorted wins) under each way of naming the store."""
    store = tmp_path / ("mlruns" if form == "cwd" else "store")
    run_id, artifact = _mlruns(store)
    if form == "cwd":
        monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)
        monkeypatch.chdir(tmp_path)
    else:
        monkeypatch.setenv("MLFLOW_TRACKING_URI", f"{form}{store}")
    monkeypatch.setattr(jax_ckpt, "_mlflow", None)
    uri = f"runs:/{run_id}/{artifact}"
    got, want = ckpt.resolve_checkpoint_uri(uri), jax_ckpt.resolve_checkpoint_uri(uri)
    assert got == want and got.endswith(os.path.join("3", run_id, "artifacts", artifact))
    assert ckpt.resolve_checkpoint_uri("plain/path.pth") == "plain/path.pth"


@pytest.mark.parametrize("uri,exc", [("runs:/", ValueError), ("runs:/abc", ValueError), ("runs://x", ValueError),
                                     ("runs:/abc/missing_artifact", FileNotFoundError)])
def test_resolve_checkpoint_uri_raises_as_jax(tmp_path, monkeypatch, uri, exc):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}")
    monkeypatch.setattr(jax_ckpt, "_mlflow", None)
    with pytest.raises(exc) as theirs:
        jax_ckpt.resolve_checkpoint_uri(uri)
    with pytest.raises(exc) as ours:
        ckpt.resolve_checkpoint_uri(uri)
    assert str(ours.value) == str(theirs.value)


def test_runs_uri_naming_an_orbax_directory_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", str(tmp_path))
    (tmp_path / "1" / "run9" / "artifacts" / "best_g_model").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.load_pretrained("runs:/run9/best_g_model")
