"""Parallelism of the port: tiled inference, host-to-device prefetch
(``prefetch.py``), and the mesh axes on ``torch.distributed`` (``mesh.py``,
``comm.py``): data-parallel training, ``--data-shard``, ``--spatial-shard``
(``spatial.py``) with ring and Ulysses attention (``ring_attention.py``,
``ulysses.py``), pipeline parallelism over the trunk (``pipeline.py``) and
tensor parallelism (``tensor.py``)."""

from srganfd_tpu_torch.parallel.prefetch import CPUPrefetcher, prefetch_to_device  # noqa: F401
