"""The port's tool CLIs on the CPU against the JAX package's: ``cli.export``
(the ``torch.export`` program and the Flax-path ``.params.npz``),
``cli.summary``, ``cli.split_dataset``, ``cli.prepare_dataset`` and
``ops/convert.py`` (tiny widths where a model is built: 16 channels,
growth 8, 2 RRDBs)."""

import filecmp
import functools
import os
import pathlib
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.cli import prepare_dataset as jax_prepare
from srganfd_tpu.cli import split_dataset as jax_split
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.models import list_models as jax_list_models
from srganfd_tpu.ops import convert as jax_convert
from srganfd_tpu_torch.cli import export as port_export
from srganfd_tpu_torch.cli import prepare_dataset, split_dataset, summary
from srganfd_tpu_torch.convert import flax_to_state_dict, flatten_flax
from srganfd_tpu_torch.models import create_model, list_models
from srganfd_tpu_torch.ops import convert
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
import port_torch_weights as port  # noqa: E402

EXPORT_ARCHS = {
    "bsrgan_x2": {"channels": 16, "growth_channels": 8, "num_rrdb": 2},
    "rrdbnet_x4": {"channels": 16, "growth_channels": 8, "num_blocks": 2},
    "realesrgan_x2": {"channels": 16, "growth_channels": 8, "num_rrdb": 2},
    "bsrgantrans_x2": {"channels": 16, "growth_channels": 8, "num_rrdb": 1},
    "gen_rrdb2x": {"num_feat": 16, "num_grow_ch": 8, "num_block": 2},
    "gen_rpa2x": {"num_feat": 16, "num_block": 2},
}


@functools.cache
def _flax_params(arch):
    """The tiny JAX model's params, from ``eval_shape``, filled from a
    numpy seed (scales near 1) so that outputs spread over [0, 1]."""
    model = create_flax(arch, **EXPORT_ARCHS[arch])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3), jnp.float32))["params"]
    rng = np.random.default_rng(len(arch))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = s.shape[0] if len(s.shape) == 3 and str(getattr(path[-2], "key", "")) != "out" \
                else int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(lambda v: v, dict(shapes)))


def _weights_npz(tmp_path, arch):
    """A ``.npz`` of a state holding the tree as G and EMA-G, which
    ``load_generator_weights(use_ema=True)`` reads."""
    tree = _flax_params(arch)
    path = tmp_path / f"{arch}_w.npz"
    np.savez(path, **port.flatten({"g_params": tree, "ema_g_params": tree}))
    return str(path)


@pytest.mark.parametrize("arch", list(EXPORT_ARCHS))
def test_export_writes_the_jax_params_npz(arch, tmp_path):
    """``<out>.params.npz``: the keys, shapes and values of the JAX export's
    flat tree (its ``visit``, the same '/'-join as
    ``tools/port_torch_weights.py``'s ``flatten``) for the same weights."""
    res = port_export.export_generator(arch, str(tmp_path / "e"), _weights_npz(tmp_path, arch), input_size=16,
                                       device="cpu", model_kwargs=EXPORT_ARCHS[arch])
    want = port.flatten(_flax_params(arch))
    with np.load(res["params"]) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want) and res["arrays"] == len(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ["bsrgan_x2", "realesrgan_x2", "gen_rpa2x"])
def test_exported_program_equals_the_module(arch, tmp_path, capsys):
    """The ``.pt2`` reloaded and run on the CPU: its output equals the
    module's bit for bit; each RDB is one ``srganfd::rdb_forward`` node
    (3 per RRDB) with its packed weights among the program's constants,
    and an arch without RDBs has none. Without ``--weights``
    the seeded init is exported, with the JAX notice."""
    kw = EXPORT_ARCHS[arch]
    res = port_export.export_generator(arch, str(tmp_path / "e"), input_size=16, batch=2, device="cpu",
                                       model_kwargs=kw)
    assert "! no --weights: exporting randomly initialized generator" in capsys.readouterr().out
    program = torch.export.load(res["program"])
    n_rdb = sum(1 for n in program.graph.nodes if "srganfd.rdb_forward" in str(n.target))
    assert n_rdb == 3 * kw.get("num_rrdb", 0)
    # each RDB's packed weights travel as two constants of the program, and
    # its convs' raw weights not at all
    assert sum(k.endswith((".packed_w", ".packed_b")) for k in program.constants) == 2 * n_rdb
    assert not [k for k in program.state_dict if ".rdb" in k]
    model = create_model(arch, generator=torch.Generator().manual_seed(0), **kw).eval()
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        got, want = program.module()(x), model(x)
    assert got.shape == want.shape and torch.equal(got, want)


def test_export_cli_main(tmp_path, capsys):
    port_export.main(["--model-arch", "gen_rpa2x", "--input-size", "8", "--out", str(tmp_path / "x" / "g"),
                      "--device-type", "cpu"])
    out = capsys.readouterr().out
    assert "exported gen_rpa2x for input (1, 8, 8, 3)" in out
    assert (tmp_path / "x" / "g.pt2").is_file() and (tmp_path / "x" / "g.params.npz").is_file()


def _jax_total(arch, size):
    model = create_flax(arch)
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(variables["params"]))


@pytest.mark.parametrize("arch", sorted(list_models()))
def test_summary_totals_match_jax(arch, capsys):
    """Every arch both registries name, at the size its D's dense head or
    scales need (128 for the discriminators, 32 otherwise)."""
    assert arch in jax_list_models()
    size = 128 if "iscriminator" in arch.lower() else 32
    summary.main(["--arch", arch, "--input-size", str(size)])
    out = capsys.readouterr().out
    total = int(next(line for line in out.splitlines() if "TOTAL" in line).split()[1].replace(",", ""))
    assert total == _jax_total(arch, size) == summary.summarize(arch)["total"]


def test_summary_lists_buffers_and_channels(capsys):
    summary.main(["--arch", "discriminator_unet", "--channels", "32"])
    out = capsys.readouterr().out
    assert "buffers: {'u':" in out
    assert summary.summarize("discriminator_unet", channels=32)["total"] == sum(
        p.numel() for p in create_model("discriminator_unet", channels=32).parameters())


def _raw_dir(d, n=7):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(9)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"img_{i}.png"), rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
    with open(os.path.join(d, "readme.txt"), "w") as f:
        f.write("skip me")


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files and not cmp.funny_files
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))
    return sorted(os.listdir(a))


@pytest.mark.parametrize("move", [False, True])
def test_split_dataset_writes_the_jax_files(tmp_path, move):
    for side in ("ours", "theirs"):
        _raw_dir(tmp_path / side / "raw")
    counts = split_dataset.split_dataset(str(tmp_path / "ours" / "raw"), str(tmp_path / "ours" / "out"), 0.6, 0.2,
                                         seed=3, move=move)
    want = jax_split.split_dataset(str(tmp_path / "theirs" / "raw"), str(tmp_path / "theirs" / "out"), 0.6, 0.2,
                                   seed=3, move=move)
    assert counts == want == {"train": 4, "valid": 1, "test": 2}
    assert _same_tree(tmp_path / "ours" / "out", tmp_path / "theirs" / "out") == ["test", "train", "valid"]
    assert sorted(os.listdir(tmp_path / "ours" / "raw")) == sorted(os.listdir(tmp_path / "theirs" / "raw"))


class _SerialPool:
    """``multiprocessing.Pool`` in the test process: a fork of a process that
    holds JAX's threads can deadlock."""

    def __init__(self, n):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, tasks):
        return [fn(t) for t in tasks]


def test_prepare_dataset_writes_the_jax_files(tmp_path, monkeypatch):
    """Both CLIs' mains on one directory (their pools run serially here):
    45 x 63 after the 0.9 bicubic scale, 24-pixel crops at stride 20, so 2 x
    2 crops an image."""
    _raw_dir(tmp_path / "raw", 3)
    monkeypatch.setattr(jax_prepare.multiprocessing, "Pool", _SerialPool)
    monkeypatch.setattr(prepare_dataset.multiprocessing, "get_context", lambda method: types.SimpleNamespace(
        Pool=_SerialPool) if method == "spawn" else None)
    for mod, out in ((prepare_dataset, "ours"), (jax_prepare, "theirs")):
        argv = ["prepare_dataset", "--images-dir", str(tmp_path / "raw"), "--output-dir", str(tmp_path / out),
                "--image-size", "24", "--step", "20", "--scale", "0.9", "--num-workers", "1"]
        monkeypatch.setattr(sys, "argv", argv)
        mod.main() if mod is jax_prepare else mod.main(argv[1:])
    files = _same_tree(tmp_path / "ours", tmp_path / "theirs")
    assert len(files) == 3 * 2 * 2 and files[0] == "img_0_00000_00000.png" and files[-1] == "img_2_00020_00020.png"


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("range_norm", [False, True])
def test_convert_matches_jax(half, range_norm, tmp_path):
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1.0, 0.5]
    t = convert.image_to_tensor(img, range_norm, half, device="cpu")
    j = jax_convert.image_to_tensor(img, range_norm, half)
    assert t.shape == (1, 5, 7, 3) and t.dtype == (torch.bfloat16 if half else torch.float32)
    assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))
    out = convert.tensor_to_image(t, range_norm, half)
    want = jax_convert.tensor_to_image(j, range_norm, half)
    assert out.dtype == np.uint8 and np.array_equal(out, want)
    assert np.array_equal(convert.tensor_to_image(t[0], range_norm, half), want)
    wide = torch.from_numpy(rng.uniform(-0.5, 1.5, size=(1, 4, 4, 3)).astype(np.float32))
    assert np.array_equal(convert.tensor_to_image(wide, range_norm, half),
                          jax_convert.tensor_to_image(jnp.asarray(wide.numpy()), range_norm, half))
    cv2.imwrite(str(tmp_path / "p.png"), (img * 255).astype(np.uint8))
    got = convert.preprocess_one_image(str(tmp_path / "p.png"), device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(jax_convert.preprocess_one_image(str(tmp_path / "p.png"))))


def test_flatten_flax_matches_the_tools_flatten():
    tree = _flax_params("bsrgan_x2")
    ours, theirs = flatten_flax(tree), port.flatten(tree)
    assert list(ours) == list(theirs) and all(np.array_equal(ours[k], theirs[k]) for k in ours)
    assert set(flax_to_state_dict(tree)) == set(create_model("bsrgan_x2", **EXPORT_ARCHS["bsrgan_x2"]).state_dict())
