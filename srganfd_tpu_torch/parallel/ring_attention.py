"""Ring attention: exact softmax attention over a token axis sharded across
the ranks (counterpart of ``srganfd_tpu/parallel/ring_attention.py``),
context parallelism for the transformer bottleneck of ``bsrgantrans_x2``.

Each rank holds its queries and one block of keys and values. The K/V
block and its key mask rotate around the ring (:func:`comm.ppermute`,
rank r to r + 1) for ``n`` hops while every rank folds the block in hand
into its queries' online softmax (the flash recurrence, f32 carries). At
hop ``s`` rank ``r`` holds rank ``(r - s) % n``'s block, so after ``n``
hops each query has seen every key exactly once. ``kv_valid`` marks the
keys a rank contributes: under ``--spatial-shard`` the tokens made from
halo rows are copies of a neighbour's interior tokens (or reflections of
its own) and are left out of the global key set.

:func:`ring_attention_loop` is the same algorithm in one process over a
list of shards, with no collective: the per-hop update is one function,
so on one device the two agree bit for bit. Forward only: gradients
through the ring are not ported (ROADMAP.md A11).
"""

from __future__ import annotations

import math

import torch

from srganfd_tpu_torch.parallel import comm
from srganfd_tpu_torch.parallel.comm import forward_only

__all__ = ["ring_attention", "ring_attention_loop"]


def _carries(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n, t, h, d = q.shape
    dev = q.device
    return (torch.zeros((n, h, t, d), dtype=torch.float32, device=dev),
            torch.full((n, h, t), -math.inf, dtype=torch.float32, device=dev),
            torch.zeros((n, h, t), dtype=torch.float32, device=dev))


def _hop(acc, m, l, q32, kb, vb, mask):
    """Fold one K/V block into the online softmax (JAX's scan body): scores
    of the valid keys, the running max, the rescaled sum and accumulator.
    A query that has seen no valid key keeps m = -inf and contributes 0."""
    scale = 1.0 / math.sqrt(q32.shape[-1])
    s = torch.einsum("nqhd,nkhd->nhqk", q32, kb) * scale
    keep = mask[None, None, None, :]
    blk_max = torch.where(keep, s, -math.inf).amax(-1)
    m_new = torch.maximum(m, blk_max)
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(keep, torch.exp(s - safe_m[..., None]), 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("nhqk,nkhd->nhqd", p, vb)
    return acc, m_new, l


def _finish(acc: torch.Tensor, l: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (acc / l[..., None]).movedim(1, 2).to(dtype)  # (N, T, H, D)


def _mask(kv_valid: torch.Tensor | None, t: int, device: torch.device) -> torch.Tensor:
    return torch.ones(t, dtype=torch.bool, device=device) if kv_valid is None else kv_valid.to(torch.bool)


@forward_only
def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Exact attention across the ranks of the default group. q/k/v: this
    rank's ``(N, T_loc, H, D)`` block of the sharded token axis;
    ``kv_valid``: optional ``(T_loc,)`` bool mask of the keys this rank
    contributes. Returns ``(N, T_loc, H, D)`` in q's dtype."""
    n_ranks = comm.world()
    q32, kb, vb = q.float(), k.float(), v.float()
    mask = _mask(kv_valid, q.shape[1], q.device)
    acc, m, l = _carries(q)
    for hop in range(n_ranks):
        acc, m, l = _hop(acc, m, l, q32, kb, vb, mask)
        if hop + 1 < n_ranks:  # JAX rotates after the last hop too; nothing reads that block
            kb, vb = comm.ppermute(kb, 1), comm.ppermute(vb, 1)
            mask = comm.ppermute(mask.to(torch.uint8), 1).to(torch.bool)
    return _finish(acc, l, q.dtype)


@forward_only
def ring_attention_loop(
    qs: list[torch.Tensor], ks: list[torch.Tensor], vs: list[torch.Tensor],
    kv_valid: list[torch.Tensor | None] | None = None,
) -> list[torch.Tensor]:
    """:func:`ring_attention` of every rank in one process: shard ``r``'s
    queries fold in shard ``(r - s) % n``'s keys at hop ``s``."""
    n = len(qs)
    masks = [_mask(None if kv_valid is None else kv_valid[i], q.shape[1], q.device) for i, q in enumerate(qs)]
    outs = []
    for r, q in enumerate(qs):
        q32 = q.float()
        acc, m, l = _carries(q)
        for hop in range(n):
            src = (r - hop) % n
            acc, m, l = _hop(acc, m, l, q32, ks[src].float(), vs[src].float(), masks[src])
        outs.append(_finish(acc, l, q.dtype))
    return outs
