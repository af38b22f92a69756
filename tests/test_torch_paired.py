"""The ``paired`` degradation on the CPU: the port's ``PairedImageDataset``
and ``TestImageDataset`` and the paired branch of ``DegradationAdapter``
against the JAX package's on one directory pair, and a tiny ``bsrnet``
run with ``degradation="paired"`` through ``cli.train.run_train`` whose
checkpoint loads."""

import os

import cv2
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.cli.degrade_adapter import DegradationAdapter as JaxAdapter
from srganfd_tpu.data import datasets as jax_datasets
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.data import datasets
from srganfd_tpu_torch.track import tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Four registered pairs: GT 32x32, LR its 2x box average (16x16), with
    an odd-valued pixel grid so the uint8 read is not a round number."""
    root = tmp_path_factory.mktemp("pairs")
    gt_dir, lr_dir = root / "gt", root / "lr"
    gt_dir.mkdir()
    lr_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        gt = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        lr = gt.reshape(16, 2, 16, 2, 3).mean((1, 3)).round().astype(np.uint8)
        cv2.imwrite(str(gt_dir / f"f{i:02d}.png"), gt)
        cv2.imwrite(str(lr_dir / f"f{i:02d}.png"), lr)
    (gt_dir / "notes.txt").write_text("not an image")
    return str(gt_dir), str(lr_dir)


@pytest.mark.parametrize("cls", ["PairedImageDataset", "TestImageDataset"])
def test_paired_datasets_match_jax(pairs, cls):
    ours = getattr(datasets, cls)(*pairs)
    theirs = getattr(jax_datasets, cls)(*pairs)
    assert len(ours) == len(theirs) == 4
    assert ours.gt_paths == theirs.gt_paths and ours.lr_paths == theirs.lr_paths
    for i in range(len(ours)):
        a, b = ours[i], theirs.__getitem__(i)
        assert set(a) == set(b) == {"gt", "lr"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32 and np.array_equal(a[k], b[k])


def test_paired_dataset_shards_and_refuses_unequal_lists(pairs, tmp_path):
    gt_dir, lr_dir = pairs
    ours = datasets.PairedImageDataset(gt_dir, lr_dir, shard=(1, 2))
    assert [os.path.basename(p) for p in ours.gt_paths] == ["f01.png", "f03.png"]
    assert datasets.PairedImageDataset(gt_dir, lr_dir).gt_paths == datasets.list_image_files(gt_dir)
    short = tmp_path / "short"
    short.mkdir()
    os.link(os.path.join(lr_dir, "f00.png"), short / "f00.png")
    with pytest.raises(ValueError, match="one LR image per GT image"):
        datasets.PairedImageDataset(gt_dir, str(short))


@pytest.mark.parametrize("train", [True, False])
def test_paired_adapter_matches_jax(pairs, train):
    """One loader batch through both adapters: GT and LR exactly as read."""
    batch = datasets.BatchLoader(datasets.PairedImageDataset(*pairs), 2, seed=5, num_workers=1, loop=False)
    host = next(iter(batch))
    cfg = configs.get_config("bsrnet", degradation="paired")
    got = DegradationAdapter(cfg, seed=0, train=train)(host, 3)
    want = JaxAdapter(jax_configs.get_config("bsrnet", degradation="paired"), seed=0, train=train)(host, 3)
    assert set(got) == set(want) == {"gt", "lr"}
    for k in got:
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert np.array_equal(got[k].numpy(), host[k])


def test_paired_bsrnet_trains_and_its_checkpoint_loads(pairs, tmp_path):
    gt_dir, lr_dir = pairs
    cfg = configs.get_config(
        "bsrnet", degradation="paired", train_gt_images_dir=gt_dir, train_lr_images_dir=lr_dir,
        valid_gt_images_dir=gt_dir, valid_lr_images_dir=lr_dir, gt_image_size=32, batch_size=2, epochs=2,
        num_workers=1, results_dir=str(tmp_path / "results"), samples_dir=str(tmp_path / "samples"))
    cfg = cfg.replace(g_kwargs={"channels": 8, "growth_channels": 4, "num_rrdb": 1})
    out = cli_train.run_train(cfg, 2, device="cpu")
    assert np.isfinite(out["best_psnr"]) and out["best_psnr"] > 0
    path = tmp_path / "results" / cfg.exp_name / "ckpt_last.pth"
    payload = ckpt.load_checkpoint(str(path))
    assert payload["step"] == 4
    state = out["state"]
    assert all(torch.equal(payload["state_dict"][k], v) for k, v in state.g_model.state_dict().items())


def test_train_datasets_for_paired_read_the_lr_dirs(pairs):
    gt_dir, lr_dir = pairs
    cfg = configs.get_config("bsrnet", degradation="paired", train_gt_images_dir=gt_dir,
                             train_lr_images_dir=lr_dir, valid_gt_images_dir=gt_dir, valid_lr_images_dir=lr_dir)
    train_ds, valid_ds = cli_train.build_datasets(cfg)
    assert isinstance(train_ds, datasets.PairedImageDataset) and isinstance(valid_ds, datasets.PairedImageDataset)
    assert train_ds[0]["lr"].shape == (16, 16, 3) and train_ds[0]["gt"].shape == (32, 32, 3)
