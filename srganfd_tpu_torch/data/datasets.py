"""Image datasets and the threaded batch loader of the port (its own copies
of ``srganfd_tpu/data/datasets.py`` ``IMAGE_EXTS``, ``list_image_files``,
``load_image_rgb``, ``TrainValidImageDataset``, ``TestImageDataset``,
``DegeneratedImageDataset``, ``PairedImageDataset`` and ``BatchLoader``).

Datasets only decode, crop and augment on the host; LR generation (the
degradation chain) runs on the device downstream. ``BatchLoader`` yields
the same batches as the JAX package's for the same seed and
``start_batch``: the index order and each record's RNG are pure functions
of (seed, batch number). The C++ loader of the JAX package
(``native/loader.cc``) is not ported (ROADMAP.md A4).
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
from typing import Any, Callable, Iterator

import cv2
import numpy as np

from srganfd_tpu_torch.ops.augment import center_crop_np, random_crop_np, random_rotate_flip_np
from srganfd_tpu_torch.ops.realesrgan_degrade import sample_kernel_triple
from srganfd_tpu_torch.parallel import comm

__all__ = [
    "IMAGE_EXTS", "list_image_files", "load_image_rgb", "TrainValidImageDataset", "TestImageDataset",
    "DegeneratedImageDataset", "PairedImageDataset", "BatchLoader",
]

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def list_image_files(directory: str, shard: tuple[int, int] | None = None) -> list[str]:
    """Sorted paths of the images in ``directory`` (by extension);
    ``shard=(index, count)`` keeps every count-th file from ``index``."""
    names = sorted(f for f in os.listdir(directory) if f.lower().endswith(IMAGE_EXTS))
    paths = [os.path.join(directory, f) for f in names]
    if shard is not None:
        index, count = shard
        paths = paths[index::count]
    return paths


def _resolve_shard(shard: tuple[int, int] | str | None) -> tuple[int, int] | None:
    """``"auto"``: this rank's shard ``(rank, world)`` under data
    parallelism, the whole list (None) in a world of one, as the JAX
    package splits by ``(jax.process_index(), jax.process_count())``;
    tuples and None pass through."""
    if shard == "auto":
        count = comm.world()
        return (comm.rank(), count) if count > 1 else None
    return shard


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to float32 RGB [0,1] HWC (cv2.imread + BGR->RGB, /255 —
    matching ``ESRGAN/dataset.py:57-66``)."""
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


class TrainValidImageDataset:
    """GT-only dataset: decode, reflect-pad images smaller than the crop,
    then Train: random crop + rotate/flip, or Valid: centre crop. RGB [0,1]
    float32 records ``{"gt": (crop, crop, 3)}``."""

    def __init__(
        self, gt_images_dir: str, gt_image_size: int, mode: str = "Train", crop_image_size: int = 0,
        shard: tuple[int, int] | str | None = "auto",
    ) -> None:
        if mode not in ("Train", "Valid"):
            raise ValueError(f"mode must be 'Train' or 'Valid', got {mode!r}")
        self.paths = list_image_files(gt_images_dir, _resolve_shard(shard))
        if not self.paths:
            raise FileNotFoundError(f"no images in {gt_images_dir}")
        self.gt_image_size = gt_image_size
        self.crop_image_size = crop_image_size or gt_image_size
        self.mode = mode

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict[str, Any]:
        rng = rng or np.random.default_rng()
        img = load_image_rgb(self.paths[index])
        size = self.crop_image_size
        h, w = img.shape[:2]
        if h < size or w < size:
            img = np.pad(img, ((0, max(0, size - h)), (0, max(0, size - w)), (0, 0)), mode="reflect")
        if self.mode == "Train":
            img = random_crop_np(img, size, rng)
            img = random_rotate_flip_np(img, rng)
        else:
            img = center_crop_np(img, size)
        return {"gt": img}


class TestImageDataset:
    """Paired GT/LR directories in sorted order (``ESRGAN/dataset.py:90-123``):
    records ``{"gt", "lr"}`` as decoded, no crop. Lists of unequal length
    raise ``ValueError`` (the JAX class asserts)."""

    def __init__(self, test_gt_images_dir: str, test_lr_images_dir: str) -> None:
        self.gt_paths = list_image_files(test_gt_images_dir)
        self.lr_paths = list_image_files(test_lr_images_dir)
        self._check_pairs()

    def _check_pairs(self) -> None:
        if len(self.gt_paths) != len(self.lr_paths):
            raise ValueError(f"{len(self.gt_paths)} GT images against {len(self.lr_paths)} LR images: "
                             "paired directories need one LR image per GT image")

    def __len__(self) -> int:
        return len(self.gt_paths)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict[str, Any]:
        return {"gt": load_image_rgb(self.gt_paths[index]), "lr": load_image_rgb(self.lr_paths[index])}


class PairedImageDataset(TestImageDataset):
    """Registered GT/LR training pairs (``Real_ESRGAN/dataset.py:153-189``,
    the ``paired`` degradation): sorted GT and LR lists of equal length,
    records ``{"gt", "lr"}`` exactly as read (no crop, flip or rounding),
    so a batch needs frames of one size. ``shard`` as
    ``list_image_files``'s, ``"auto"`` by default."""

    def __init__(self, gt_images_dir: str, lr_images_dir: str, shard: tuple[int, int] | str | None = "auto") -> None:
        shard = _resolve_shard(shard)
        self.gt_paths = list_image_files(gt_images_dir, shard)
        self.lr_paths = list_image_files(lr_images_dir, shard)
        self._check_pairs()


class DegeneratedImageDataset:
    """Real-ESRGAN dataset (``Real_ESRGAN/dataset.py:34-150``): the GT crop
    of ``TrainValidImageDataset``, then the per-sample kernel triple
    ``kernel1``, ``kernel2`` and ``sinc_kernel`` ((K, K) f32 each, K =
    ``sinc_kernel_size``), drawn after the crop from the record's rng."""

    def __init__(
        self, gt_images_dir: str, gt_image_size: int, degradation_model_params: dict, mode: str = "Train"
    ) -> None:
        self.inner = TrainValidImageDataset(gt_images_dir, gt_image_size, mode)
        self.params = degradation_model_params

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict[str, Any]:
        rng = rng or np.random.default_rng()
        rec = self.inner.__getitem__(index, rng)
        k1, k2, sinc = sample_kernel_triple(rng, self.params)
        rec.update({"kernel1": k1, "kernel2": k2, "sinc_kernel": sinc})
        return rec


class BatchLoader:
    """Threaded, seeded batch iterator of stacked numpy dicts: infinite with
    ``loop`` (training), one pass without (validation). cv2 decoding
    releases the GIL, so a thread pool decodes in parallel."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch_batches: int = 4,
        loop: bool = True,
        collate_fn: Callable[[list[dict]], dict] | None = None,
        start_batch: int = 0,
    ) -> None:
        """``start_batch`` seeks the stream: the iterator yields batch
        ``start_batch`` first, equal to what an un-sought loader yields at
        that position, without decoding the batches before it."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.loop = loop
        self.collate_fn = collate_fn or self._default_collate
        self.start_batch = int(start_batch)

    @staticmethod
    def _default_collate(records: list[dict]) -> dict:
        return {k: np.stack([r[k] for r in records]) for k in records[0]}

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_stream(self) -> Iterator[list[int]]:
        n = len(self.dataset)
        bpp = len(self)  # batches per pass over the dataset
        # batch k lives at (pass k // bpp, slot k % bpp)
        epoch = self.start_batch // bpp if bpp else 0
        slot = self.start_batch % bpp if bpp else 0
        while True:
            order = np.arange(n)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
            for bi in range(slot, bpp):
                yield list(order[bi * self.batch_size : (bi + 1) * self.batch_size])
            slot = 0
            if not self.loop:
                return
            epoch += 1

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=self.num_workers)
        counter = iter(range(self.start_batch, 1 << 62))

        def fetch(batch_idx: list[int], batch_no: int) -> dict:
            records = []
            for j, i in enumerate(batch_idx):
                rng = np.random.default_rng((self.seed, batch_no, j))
                records.append(self.dataset.__getitem__(int(i), rng))
            return self.collate_fn(records)

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch_idx in self._index_stream():
                    if stop.is_set() or not put(pool.submit(fetch, batch_idx, next(counter))):
                        return
            except RuntimeError:  # the pool was shut down under us: the consumer left
                return
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item.result()
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            thread.join(timeout=5.0)
