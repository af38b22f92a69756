"""Ulysses attention: the all-to-all alternative to ring attention for
context-parallel serving (counterpart of ``srganfd_tpu/parallel/ulysses.py``).

Tokens arrive sharded by sequence. One :func:`comm.all_to_all` regroups
q, k and v so that each rank holds every token for ``H / n`` of the heads;
full softmax attention runs there per head, in f32; a second all-to-all
gives back the sequence sharding. The key mask is all-gathered. The head
count caps the ranks: ``bsrgantrans_x2``'s 4 heads allow at most 4, where
ring attention takes any count. Scores are O(T_glob^2) per rank: on large
frames ring attention (O(T_loc^2) per hop) is the backend that fits.

:func:`ulysses_attention_loop` computes the same head groups in one
process over a list of shards, with no collective. Both are
differentiable: the backward is autograd through :func:`comm.all_to_all`,
whose transpose is the all-to-all with the two axes swapped.
"""

from __future__ import annotations

import math

import torch

from srganfd_tpu_torch.parallel import comm

__all__ = ["ulysses_attention", "ulysses_attention_loop", "check_heads"]


def check_heads(h: int, n: int) -> None:
    """The JAX package's refusal when the heads do not split over the ranks."""
    if h % n:
        raise ValueError(
            f"ulysses attention shards heads: num_heads={h} must divide by the 'data' axis size {n} "
            "(BSRGANtrans has 4 heads -> <=4-way; use ring attention beyond that)"
        )


def _attend(q32: torch.Tensor, k32: torch.Tensor, v32: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Softmax attention of one head group over the whole token axis,
    (N, T, h, D) in f32."""
    s = torch.einsum("nqhd,nkhd->nhqk", q32, k32) / math.sqrt(q32.shape[-1])
    if mask is not None:
        s = torch.where(mask[None, None, None, :], s, -math.inf)
    return torch.einsum("nhqk,nkhd->nqhd", s.softmax(-1), v32)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor | None = None,
    group: comm.Group = None,
) -> torch.Tensor:
    """Exact attention through head-sharded all-to-alls over ``group`` (the
    default group when None). q/k/v: this rank's ``(N, T_loc, H, D)`` block
    of the sharded token axis, ``H`` a multiple of the group's size;
    ``kv_valid`` as ring attention's. Returns ``(N, T_loc, H, D)`` in q's
    dtype."""
    n = comm.world(group)
    check_heads(q.shape[2], n)
    # (N, T_loc, H, D) -> (N, T_glob, H / n, D)
    q32, k32, v32 = (comm.all_to_all(t.float(), 2, 1, group) for t in (q, k, v))
    mask = None
    if kv_valid is not None:
        mask = comm.all_gather(kv_valid.to(torch.uint8), 0, group).to(torch.bool)
    out = _attend(q32, k32, v32, mask)
    return comm.all_to_all(out, 1, 2, group).to(q.dtype)  # back to (N, T_loc, H, D)


def ulysses_attention_loop(
    qs: list[torch.Tensor], ks: list[torch.Tensor], vs: list[torch.Tensor],
    kv_valid: list[torch.Tensor | None] | None = None,
) -> list[torch.Tensor]:
    """:func:`ulysses_attention` of every rank in one process: head group
    ``g`` attends over the concatenation of every shard's tokens."""
    n = len(qs)
    h = qs[0].shape[2]
    check_heads(h, n)
    hn, t_loc = h // n, qs[0].shape[1]
    mask = None if kv_valid is None else torch.cat([m.to(torch.bool) for m in kv_valid])
    cat = lambda ts, g: torch.cat([t.float()[:, :, g * hn:(g + 1) * hn] for t in ts], 1)  # noqa: E731
    groups = [_attend(cat(qs, g), cat(ks, g), cat(vs, g), mask) for g in range(n)]
    return [torch.cat([o[:, r * t_loc:(r + 1) * t_loc] for o in groups], 2).to(qs[0].dtype) for r in range(n)]
