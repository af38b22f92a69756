"""Tensor parallelism of the port (``parallel/tensor.py``
``channel_sharded_params``) on four gloo CPU ranks, a ``(2, 2)``
``("model", "data")`` mesh, against the JAX package's channel-sharded
forward (``tests/test_parallel_tensor.py``).

The ranks are subprocesses (``tests/torch_dist_worker.py``); the JAX side
runs here. A tiny ``bsrgan_x2`` (8 channels, growth 4, 1 RRDB) from one
Flax tree through ``convert.flax_to_state_dict``: each rank keeps its half
of the output channels of every conv whose ``Cout`` 2 divides (the RDB's
five convs gathered once per forward into the kernel's weights), the
3-channel head whole, and forwards its data row's half of the batch. The
rows, joined, equal JAX's replicated forward to 2e-5, the JAX test's own
tolerance; the two ranks of a data row agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.parallel import make_mesh
from srganfd_tpu.parallel.tensor import channel_sharded_params as jax_channel_sharded
from srganfd_tpu_torch.convert import flax_to_state_dict
from test_torch_dist_train import _filled
from torch_dist_worker import start_ranks
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ARCH = "bsrgan_x2"
TINY = {"channels": 8, "growth_channels": 4, "num_rrdb": 1}
MESH = (2, 2)  # ("model", "data")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    model = create_flax(ARCH, **TINY)
    lr = np.random.default_rng(0).uniform(size=(4, 12, 12, 3)).astype(np.float32)
    params = _filled(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(lr)), 6)["params"]
    state = {k: np.asarray(v) for k, v in flax_to_state_dict(params).items()}
    launch = start_ranks(4, [("tp", "tensor", {"arch": ARCH, "kwargs": TINY, "state": state, "lr": lr})],
                         tmp_path_factory.mktemp("tp"), timeout=150)
    mesh = make_mesh(MESH, ("model", "data"), devices=jax.devices()[:4])
    sharded = jax_channel_sharded(params, mesh, axis="model")
    apply = jax.jit(lambda p, z: model.apply({"params": p}, z))
    want = np.asarray(apply(params, lr))
    jax_tp = np.asarray(apply(sharded, jax.device_put(jnp.asarray(lr), NamedSharding(mesh, P()))))
    return {"ranks": [r["tp"] for r in launch.wait()], "want": want, "jax_tp": jax_tp, "state": state}


def test_channel_sharded_forward_matches_replicated_jax(run):
    """Each data row's frames, by either of its model ranks, equal JAX's
    replicated forward (and its channel-sharded one) to 2e-5."""
    res = run["ranks"]
    assert all("error" not in r for r in res), [r.get("error") for r in res]
    for r in res:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["sr"], run["want"][lo:hi], atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(r["sr"], run["jax_tp"][lo:hi], atol=2e-5, rtol=1e-5)
    assert sorted(tuple(r["rows"]) for r in res) == [(0, 2), (0, 2), (2, 4), (2, 4)]
    by_rows = {}
    for r in res:
        by_rows.setdefault(tuple(r["rows"]), []).append(r["sr"])
    assert all(np.array_equal(a, b) for a, b in by_rows.values())


def test_which_tensors_are_sharded(run):
    """Every conv whose output channels 2 divides holds half of them (its
    kernel and bias), the RDB's too; the 3-channel head stays whole, as
    JAX's ``channel_sharded_params`` leaves ragged shapes replicated."""
    res = run["ranks"]
    assert {r["model_index"] for r in res} == {0, 1}
    for r in res:
        for k, shape in r["shapes"].items():
            whole = run["state"][k].shape
            if whole[0] % 2 == 0:
                assert shape == (whole[0] // 2, *whole[1:]), (k, shape, whole)
            else:
                assert shape == whole, (k, shape)
    heads = [k for k, v in run["state"].items() if v.shape[0] == 3]
    assert heads == ["conv4.weight", "conv4.bias"]
    assert any(k.startswith("trunk.0.rdb1.conv1") for k in res[0]["shapes"])
