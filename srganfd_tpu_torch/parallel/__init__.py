"""Parallelism of the port: tiled inference, and the ``data`` axis on
``torch.distributed`` (``mesh.py``, ``comm.py``): data-parallel training,
``--data-shard``, ``--spatial-shard`` (``spatial.py``) with ring and Ulysses
attention (``ring_attention.py``, ``ulysses.py``)."""
