"""Context parallelism of the port (ring and Ulysses attention, and the
transformer generator's ``--spatial-shard``) on gloo CPU ranks, against the
JAX package's on meshes of as many virtual devices and against unsharded
attention.

The ranks are subprocesses (``tests/torch_dist_worker.py``), each with a
timeout; the JAX side runs here. Held at 1e-5:

- ``ring_attention`` and ``ulysses_attention`` on 2 and 4 ranks, with a
  key mask that leaves out each shard's first and last tokens (the halo
  tokens of ``--spatial-shard``), against JAX's under ``shard_map`` and
  against masked softmax attention over the whole token axis in f64; the
  one-process loops (``ring_attention_loop``, ``ulysses_attention_loop``)
  equal the collective runs bit for bit. Ring attention runs on 3 ranks,
  where Ulysses refuses 4 heads with JAX's message;
- a tiny ``bsrgantrans_x2`` (16 channels, growth 8, 2 RRDBs, 4 heads of
  4) sharded by rows on 2 ranks with ring attention and on 4 with Ulysses,
  against JAX's ``spatial_sharded_sr`` of the model with ``ring_axis``, and
  its one-process loop (``forward_shards``) bit for bit.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.parallel import make_mesh
from srganfd_tpu.parallel.ring_attention import ring_attention as jax_ring
from srganfd_tpu.parallel.spatial import spatial_sharded_sr as jax_spatial_sr
from srganfd_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from srganfd_tpu_torch.convert import flax_to_state_dict
from srganfd_tpu_torch.models import create_model as create_port
from test_torch_bsrgantrans import ARCH, TINY, trans_params
from torch_dist_worker import run_ranks
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

N, HEADS, D = 2, 4, 8
T_PER_RANK = {2: 24, 3: 16, 4: 12}
BACKENDS = ("ring", "ulysses")
HALO = 4
FRAME = (24, 16)
TRANS = {2: "ring", 4: "ulysses"}  # the generator's backend on each rank count


def _qkv(n):
    t = T_PER_RANK[n] * n
    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(N, t, HEADS, D)).astype(np.float32) for _ in range(3))
    row = np.arange(t) % T_PER_RANK[n]
    mask = (row >= 2) & (row < T_PER_RANK[n] - 2)  # each shard's halo tokens left out
    return q, k, v, mask


def _reference(q, k, v, mask):
    """Masked softmax attention over the whole token axis, f64."""
    s = np.einsum("nqhd,nkhd->nhqk", q.astype(np.float64), k.astype(np.float64)) / math.sqrt(D)
    s = np.where(mask[None, None, None, :], s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("nhqk,nkhd->nqhd", w, v.astype(np.float64))


def _jax_attention(backend, n, q, k, v, mask):
    fn = jax_ring if backend == "ring" else jax_ulysses
    mesh = make_mesh(devices=jax.devices()[:n])
    run = shard_map(lambda a, b, c, m: fn(a, b, c, "data", m), mesh=mesh,
                    in_specs=(P(None, "data"),) * 3 + (P("data"),), out_specs=P(None, "data"), check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))


def _trans_state():
    return {k: np.asarray(v) for k, v in flax_to_state_dict(trans_params()).items()}


def _frame():
    return np.random.default_rng(3).uniform(size=(*FRAME, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for n in (2, 3, 4):
        q, k, v, mask = _qkv(n)
        cases = [(b, "attention", {"backend": b, "q": q, "k": k, "v": v, "kv_valid": mask}) for b in BACKENDS]
        if n in TRANS:
            cases.append(("trans", "spatial", {"arch": ARCH, "kwargs": TINY, "state": _trans_state(),
                                               "image": _frame(), "halo": HALO, "row_multiple": 2,
                                               "cp": TRANS[n]}))
        out[n] = run_ranks(n, cases, tmp_path_factory.mktemp(f"cp{n}"), timeout=150)
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_attention_matches_jax_and_unsharded(backend, n, ranks):
    """The ranks' outputs, concatenated, are JAX's sharded attention and the
    unsharded masked attention to 1e-5."""
    q, k, v, mask = _qkv(n)
    results = [r[backend] for r in ranks[n]]
    assert all("error" not in r for r in results), results
    got = np.concatenate([r["out"] for r in results], 1)
    np.testing.assert_allclose(got, _jax_attention(backend, n, q, k, v, mask), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _reference(q, k, v, mask), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_the_attention_loops_are_the_collective_runs_bit_for_bit(backend, n, ranks):
    results = [r[backend] for r in ranks[n]]
    for r, res in enumerate(results):
        assert np.array_equal(results[0]["loop"][r], res["out"]), r


def test_ring_takes_three_ranks_where_ulysses_refuses_four_heads_as_jax(ranks):
    q, k, v, mask = _qkv(3)
    got = np.concatenate([r["ring"]["out"] for r in ranks[3]], 1)
    np.testing.assert_allclose(got, _reference(q, k, v, mask), atol=1e-5, rtol=0)
    errors = {r["ulysses"].get("error") for r in ranks[3]}
    with pytest.raises(ValueError) as jax_error:
        _jax_attention("ulysses", 3, q, k, v, mask)
    assert errors == {f"ValueError: {jax_error.value}"}


@pytest.mark.parametrize("n", sorted(TRANS))
def test_bsrgantrans_spatial_shard_matches_jax(n, ranks):
    """The frame SR'd on ``n`` ranks with the attention over all of them
    (``TRANS[n]``) is JAX's ``spatial_sharded_sr`` of the ``ring_axis``
    model on ``n`` devices, to 1e-5; every rank holds it, and the
    one-process ``forward_shards`` loop equals it bit for bit."""
    halo = HALO
    model = create_flax(ARCH, **TINY, ring_axis="data", ring_halo=halo, cp_backend=TRANS[n])
    want = jax_spatial_sr(jax.jit(lambda p, z: model.apply({"params": p}, z)), trans_params(), _frame(), 2,
                          make_mesh(devices=jax.devices()[:n]), halo=halo, row_multiple=2)
    res = [r["trans"] for r in ranks[n]]
    assert all("error" not in r for r in res), res
    for r in res:
        np.testing.assert_allclose(r["sr"], want, atol=1e-5, rtol=0)
        assert np.array_equal(r["sr"], res[0]["sr"])
    assert np.array_equal(res[0]["loop"], res[0]["sr"])


def _port_trans(**kw):
    model = create_port(ARCH, **TINY, **kw)
    model.load_state_dict({k: torch.tensor(v) for k, v in _trans_state().items()})
    return model.eval()


def test_unknown_cp_backend_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown cp_backend 'rnig'"):
        _port_trans(ring_axis="data", ring_halo=HALO, cp_backend="rnig")
    model = create_flax(ARCH, **TINY, ring_axis="data", ring_halo=HALO, cp_backend="rnig")
    with pytest.raises(ValueError, match="unknown cp_backend 'rnig'"):
        jax.eval_shape(functools.partial(model.init, jax.random.PRNGKey(0)), jnp.zeros((1, 8, 8, 3)))


def test_a_ring_axis_ignores_attn_chunk_and_backend():
    """Under a ring axis the attention is the ring's whatever ``attn_chunk``
    and ``attn_backend`` say, as the JAX layer's branch order has it; in a
    world of one it is the ring of one rank, halo tokens masked."""
    x = torch.from_numpy(np.random.default_rng(4).uniform(size=(1, 16, 12, 3)).astype(np.float32))
    with torch.inference_mode():
        plain = _port_trans(ring_axis="data", ring_halo=HALO)(x)
        chunked = _port_trans(ring_axis="data", ring_halo=HALO, attn_chunk=8, attn_backend="flash")(x)
    assert torch.equal(plain, chunked)
    model = create_flax(ARCH, **TINY, ring_axis="data", ring_halo=HALO)
    mesh = make_mesh(devices=jax.devices()[:1])
    want = jax_spatial_sr(jax.jit(lambda p, z: model.apply({"params": p}, z)), trans_params(),
                          x[0].numpy(), 2, mesh, halo=HALO, row_multiple=2)
    from srganfd_tpu_torch.parallel.spatial import spatial_sharded_sr

    got = spatial_sharded_sr(_port_trans(ring_axis="data", ring_halo=HALO), x[0].numpy(), 2, halo=HALO,
                             row_multiple=2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ring_axis_names_the_data_axis_only():
    with pytest.raises(ValueError, match="'data'"):
        _port_trans(ring_axis="model", ring_halo=HALO)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gradients_through_cp_attention_are_refused_naming_the_item(backend):
    """The context-parallel attentions are forward only: a call autograd
    would differentiate raises, naming ROADMAP.md A11 (JAX differentiates
    them, ``tests/test_ring_attention.py``, but no entry point does), while
    a call without a graph runs."""
    from srganfd_tpu_torch.parallel.ring_attention import ring_attention
    from srganfd_tpu_torch.parallel.ulysses import ulysses_attention

    fn = ring_attention if backend == "ring" else ulysses_attention
    q = torch.randn(1, 8, HEADS, D, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A11"):
        fn(q, q, q)
    with torch.no_grad():
        assert fn(q, q, q).shape == q.shape
    model = _port_trans(ring_axis="data", ring_halo=HALO, cp_backend=backend)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A11"):
        model(torch.rand(1, 16, 12, 3))
