"""The port's native C++ loader (``srganfd_tpu_torch/data/native_loader.py``,
``csrc/loader.cc``) against the JAX package's (``srganfd_tpu/data/native_loader.py``),
and the port's ``parallel.prefetch``.

For the same paths, crop, batch, seed, ``start_batch``, ``train`` and
``uint8`` the two loaders give the same batches byte for byte, and the same
decodes; the port's stream does not depend on the thread count and its
``start_batch`` seeks it (``tests/test_native_loader.py``'s own checks,
mirrored). Where the library cannot be built ``available()`` is False with
its reason, and ``cli.train`` says so in one line and uses ``BatchLoader``.
``prefetch_to_device`` keeps the order of its batches and each rank's row
of a mesh's ``data`` axis. Seeded synthetic PNGs and JPEGs."""

import os

import cv2
import numpy as np
import pytest
import torch

from srganfd_tpu.data import native_loader as jax_loader
from srganfd_tpu_torch.data import native_loader
from srganfd_tpu_torch.parallel import CPUPrefetcher, prefetch_to_device
from srganfd_tpu_torch.parallel.mesh import Mesh
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.default_rng(0)
    for i in range(5):
        h, w = (90, 110) if i % 2 else (40, 36)  # two smaller than a crop: reflect-extended
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(d / f"a{i}.png"), img)
        cv2.imwrite(str(d / f"b{i}.jpg"), img, [int(cv2.IMWRITE_JPEG_QUALITY), 90])
    return str(d)


@pytest.fixture(scope="module")
def both_built():
    if not native_loader.available():
        pytest.skip(f"native loader not built here: {native_loader.unavailable_reason()}")
    if not jax_loader.available():
        pytest.skip("the JAX package's native loader is not built here")


def _paths(image_dir, ext=None):
    return sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir) if ext is None or f.endswith(ext))


def _take(module, paths, n, **kw):
    ld = module.NativeBatchLoader(paths, **kw)
    it = iter(ld)
    out = [np.array(next(it)["gt"]) for _ in range(n)]
    ld.close()
    return out


@pytest.mark.parametrize("uint8,train,start_batch,crop", [
    (True, True, 0, 48), (False, True, 0, 48), (True, True, 5, 48), (True, False, 0, 48), (False, True, 3, 64),
])
def test_batches_equal_the_jax_loaders_byte_for_byte(image_dir, both_built, uint8, train, start_batch, crop):
    """Seven batches of 3 over 10 images: more than two epochs of the
    loaders' own shuffle, PNG and JPEG, images below the crop included."""
    kw = dict(crop=crop, batch_size=3, seed=7, num_threads=3, train=train, uint8=uint8, start_batch=start_batch)
    paths = _paths(image_dir)
    ours, theirs = _take(native_loader, paths, 7, **kw), _take(jax_loader, paths, 7, **kw)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == (np.uint8 if uint8 else np.float32)
        assert a.shape == (3, crop, crop, 3)
        assert a.tobytes() == b.tobytes()
    assert any(a.tobytes() != ours[0].tobytes() for a in ours[1:])


@pytest.mark.parametrize("name", ["a1.png", "b1.jpg", "a0.png"])
def test_decode_equals_the_jax_decode(image_dir, both_built, name):
    path = os.path.join(image_dir, name)
    got, want = native_loader.decode_image_native(path), jax_loader.decode_image_native(path)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    if name.endswith(".png"):
        np.testing.assert_allclose(got, cv2.imread(path)[..., ::-1] / np.float32(255.0), atol=1e-6)
    assert native_loader.decode_image_native(os.path.join(image_dir, "missing.png")) is None


def test_emission_order_is_thread_count_invariant(image_dir, both_built):
    paths = _paths(image_dir, ".png")
    a = _take(native_loader, paths, 6, crop=32, batch_size=2, seed=5, num_threads=1)
    b = _take(native_loader, paths, 6, crop=32, batch_size=2, seed=5, num_threads=8)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_start_batch_seeks_the_stream(image_dir, both_built):
    paths = _paths(image_dir, ".png")
    full = _take(native_loader, paths, 6, crop=32, batch_size=2, seed=9, num_threads=3)
    sought = _take(native_loader, paths, 3, crop=32, batch_size=2, seed=9, num_threads=3, start_batch=3)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(full[3:], sought))


def test_uint8_batches_are_the_float_batches_times_255(image_dir, both_built):
    paths = _paths(image_dir, ".png")
    f = _take(native_loader, paths, 3, crop=48, batch_size=2, seed=7, num_threads=1)
    u = _take(native_loader, paths, 3, crop=48, batch_size=2, seed=7, num_threads=1, uint8=True)
    for a, b in zip(f, u):
        np.testing.assert_allclose(a, b.astype(np.float32) / 255.0, atol=1e-6)


def test_a_failed_build_makes_it_unavailable_with_its_reason(tmp_path, monkeypatch):
    """A source g++ cannot compile (as a host without libjpeg's headers
    would fail it): ``available()`` False, the reason names the error, and
    the constructor raises with it."""
    bad = tmp_path / "loader.cc"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_reason", "")
    assert not native_loader.available()
    assert "no_such_header_here.h" in native_loader.unavailable_reason()
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native_loader.NativeBatchLoader([str(bad)], crop=8, batch_size=1)
    assert native_loader.decode_image_native(str(bad)) is None
    assert not list((tmp_path / "build").glob("*.tmp"))  # the failed build left no partial file


def test_prefetch_to_device_keeps_order_and_moves():
    batches = [{"x": np.full((4, 2), i, np.float32), "y": (torch.full((2,), i),)} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        assert torch.equal(b["y"][0], batches[i]["y"][0])
    assert list(prefetch_to_device(iter([]), size=3, device="cpu")) == []


@pytest.mark.parametrize("index", [0, 1])
def test_prefetch_keeps_this_ranks_row_of_the_data_axis(index):
    mesh = Mesh(("data",), (2,), (index,), {})
    batches = [{"x": np.arange(8, dtype=np.float32).reshape(8, 1) + 10 * i} for i in range(3)]
    out = list(prefetch_to_device(iter(batches), size=2, mesh=mesh, device="cpu"))
    for i, b in enumerate(out):
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"][4 * index:4 * index + 4])
    with pytest.raises(ValueError, match="does not split"):
        list(prefetch_to_device(iter([{"x": np.zeros((3, 1))}]), mesh=mesh, device="cpu"))


def test_cpu_prefetcher_protocol():
    pf = CPUPrefetcher([1, 2, 3])
    assert pf.next() == 1 and pf.next() == 2 and len(pf) == 3
    pf.reset()
    assert pf.next() == 1
    pf.next(), pf.next()
    assert pf.next() is None


@pytest.mark.parametrize("native", ["1", "0"])
def test_cli_train_takes_the_native_loader_or_says_why_not(image_dir, tmp_path, monkeypatch, capsys, native):
    """``cli.train`` on a GT-crop config: the native loader where it builds
    (its stream: every step's uint8 batch is the loader's own), the Python
    ``BatchLoader`` with ``SRGANFD_NATIVE_LOADER=0`` (silently, as in JAX),
    or, where the library cannot be built, one line that says why."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.data.datasets import BatchLoader

    monkeypatch.setenv("SRGANFD_NATIVE_LOADER", native)
    cfg = configs.get_config("rrdbnet", train_gt_images_dir=image_dir, valid_gt_images_dir=image_dir, gt_image_size=32,
                             batch_size=2)
    dev = torch.device("cpu")
    loader = cli_train.build_train_loader(cfg, cli_train.build_datasets(cfg)[0], 3, dev)
    out = capsys.readouterr().out
    if native == "0":
        assert isinstance(loader, BatchLoader) and out == ""
        return
    if native_loader.available():
        assert isinstance(loader, native_loader.NativeBatchLoader) and "using native C++ data loader" in out
        want = _take(native_loader, cli_train.build_datasets(cfg)[0].paths, 1, crop=32, batch_size=2, seed=cfg.seed,
                     num_threads=2, uint8=True, start_batch=3)[0]
        assert np.array(next(iter(loader))["gt"]).tobytes() == want.tobytes()
        loader.close()
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_reason", "g++ failed to build loader.cc: jpeglib.h: No such file")
    assert isinstance(cli_train.build_train_loader(cfg, cli_train.build_datasets(cfg)[0], 0, dev), BatchLoader)
    assert capsys.readouterr().out == ("! native C++ data loader unavailable (g++ failed to build loader.cc: "
                                       "jpeglib.h: No such file): using the Python BatchLoader\n")
