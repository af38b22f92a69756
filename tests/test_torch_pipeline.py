"""Pipeline parallelism of the port (``parallel/pipeline.py`` and the
Trainer's ``pipe`` axis) on gloo CPU ranks against the JAX package's on
meshes of as many virtual devices.

The ranks are subprocesses (``tests/torch_dist_worker.py``), launched once
per world size; the JAX side runs here. A tiny ``bsrgan_x2`` (8 channels,
growth 4, 5 RRDBs, ``scan_blocks``) whose weights come from one Flax tree
through ``convert.flax_to_state_dict``:

- the pipelined trunk on 2 and 4 stages (5 blocks: a padded slot on
  both), 2 microbatches, in f32: its output and the gradients of
  ``sum(trunk(x) * cot)`` (x's and every block's, summed over the axis)
  against the port's own sequential trunk to 1e-6 and against JAX's
  ``pipelined_trunk_apply`` under ``jax.grad`` to 1e-5, each of a tensor's
  largest entry; each block's gradient lies on its owner rank alone; the
  whole generator's pipelined L1 gradients against its sequential ones to
  1e-6;
- two ``bsrnet`` steps on a ``(2, 2)`` ``("data", "pipe")`` mesh of four
  ranks, in f64, against JAX's ``Trainer`` on the same mesh: the losses,
  G and EMA-G to 1e-9, the four ranks alike bit for bit, and batch-1
  ``eval_sr`` (the sequential trunk on both sides);
- a ``pipe`` axis without ``scan_blocks`` raises JAX's ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.models.blocks import RRDB
from srganfd_tpu.parallel import make_mesh
from srganfd_tpu.parallel.pipeline import pad_stages as jax_pad_stages
from srganfd_tpu.parallel.pipeline import pipelined_trunk_apply as jax_pipelined_trunk
from srganfd_tpu.parallel.pipeline import split_trunk_params as jax_split
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu.train.state import GanTrainState
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.convert import flax_to_state_dict
from srganfd_tpu_torch.train.loop import Trainer
from test_torch_dist_train import _filled
from test_torch_esrgan_lockstep import _jax_state_in_f64
from torch_dist_worker import start_ranks
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ARCH = "bsrgan_x2"
TINY = {"channels": 8, "growth_channels": 4, "num_rrdb": 5, "scan_blocks": True}
STAGES = (2, 4)
MICRO = 2
BATCH, SIZE = 4, 8
PP_MESH = (2, 2)  # ("data", "pipe")
STEPS = 2
GT = 16


def _params(model, seed):
    return _filled(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))), seed)["params"]


def _state(params):
    return {k: np.asarray(v) for k, v in flax_to_state_dict(params).items()}


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH, SIZE, SIZE, TINY["channels"])).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    lr = rng.uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return x, cot, lr


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _pp_overrides(**over):
    return {"compute_dtype": "float64", "epochs": 4, "g_kwargs": TINY, "mesh_shape": PP_MESH,
            "mesh_axes": ("data", "pipe"), "pipeline_microbatches": MICRO, **over}


def _pp_config(jax_side: bool, **over):
    return (jax_configs if jax_side else configs).get_config("bsrnet", **_pp_overrides(**over))


def _pairs():
    gts = np.random.default_rng(9).uniform(size=(STEPS, 2 * PP_MESH[0], GT, GT, 3))
    gts = gts.astype(np.float32).astype(np.float64)
    return gts, np.ascontiguousarray(gts[:, :, ::2, ::2, :])


@pytest.fixture(scope="module")
def flax():
    model = create_flax(ARCH, **TINY)
    params = _params(model, 3)
    return model, params


@pytest.fixture(scope="module")
def jax_init():
    """The JAX Trainer on the (data, pipe) mesh, its initial state in f64,
    replicated, and that state's G as the port's state dict."""
    mesh = make_mesh(PP_MESH, ("data", "pipe"), devices=jax.devices()[:4])
    jtr = JaxTrainer(_pp_config(True), steps_per_epoch=1, mesh=mesh)
    g = _params(jtr.g_model, 4)
    jst = _jax_state_in_f64(jtr, GanTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g, g_opt_state=jtr.g_tx.init(g),
        ema_g_params=jax.tree_util.tree_map(jnp.copy, g), d_params=None, d_opt_state=None, d_vars=None))
    return {"mesh": mesh, "jtr": jtr, "init": _state(jst.g_params), "jst": jax.device_put(jst, NamedSharding(mesh, P()))}


@pytest.fixture(scope="module")
def launch(flax, jax_init, tmp_path_factory):
    """Both world sizes' ranks, started before the JAX side runs here."""
    _, params = flax
    x, cot, lr = _inputs()
    case = ("pipeline", "pipeline", {"arch": ARCH, "kwargs": TINY, "state": _state(params), "x": _nchw(x),
                                     "cot": _nchw(cot), "lr": lr, "microbatches": MICRO})
    gts, lrs = _pairs()
    step = ("train", "pp_train", {"overrides": _pp_overrides(), "init": jax_init["init"], "gts": gts, "lrs": lrs,
                                  "eval_lr": lrs[0, :1]})
    return {n: start_ranks(n, [case] + ([step] if n == 4 else []), tmp_path_factory.mktemp(f"pp{n}"), timeout=300)
            for n in STAGES}


@pytest.fixture(scope="module")
def jax_step(jax_init, launch):
    """The JAX Trainer's two f64 steps on the (data, pipe) mesh and its
    batch-1 eval (while the ranks run)."""
    jtr, jst = jax_init["jtr"], jax_init["jst"]
    batch = NamedSharding(jax_init["mesh"], P("data"))
    gts, lrs = _pairs()
    metrics = []
    for i in range(STEPS):
        jst, m = jtr.train_step(jst, jax.device_put(jnp.asarray(gts[i]), batch), jax.device_put(jnp.asarray(lrs[i]), batch))
        metrics.append([float(m[k]) for k in ("pixel_loss", "g_loss")])
    return {"metrics": metrics, "g": _state(jst.g_params), "ema": _state(jst.ema_g_params),
            "eval": np.asarray(jtr.eval_sr(jst.g_params, jnp.asarray(lrs[0, :1])))}


@pytest.fixture(scope="module")
def trunks(flax, launch):
    """JAX's pipelined trunk on each stage count (while the ranks run)."""
    return {n: _jax_trunk(flax[1], n) for n in STAGES}


@pytest.fixture(scope="module")
def ranks(launch, jax_step, trunks):
    return {n: handle.wait() for n, handle in launch.items()}


def _jax_trunk(params, n_stages):
    """JAX's pipelined trunk on ``n_stages`` devices: its output and the
    gradients of sum(out * cot) in x and in the real blocks (port names)."""
    x, cot, _ = _inputs()
    mesh = make_mesh((n_stages,), ("pipe",), devices=jax.devices()[:n_stages])
    nontrunk, stacked = jax_split(params)
    padded, mask = jax_pad_stages(stacked, n_stages)
    block = RRDB(TINY["channels"], TINY["growth_channels"], jnp.float32)

    def run(s, z):
        return jax_pipelined_trunk(lambda p, h: block.apply({"params": p}, h), s, mask, z, mesh, microbatches=MICRO)

    y, vjp = jax.vjp(jax.jit(run), padded, jnp.asarray(x))
    d_stacked, dx = vjp(jnp.asarray(cot))
    real = jax.tree_util.tree_map(lambda a: a[:TINY["num_rrdb"]], d_stacked)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, nontrunk)
    named = flax_to_state_dict({**zeros, "ScanRRDB": {"RRDB_0": real}})
    return np.asarray(y), np.asarray(dx), {k: np.asarray(v) for k, v in named.items() if k.startswith("trunk.")}


def _close(got, want, tol, what):
    off = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert off <= tol, (what, off)


@pytest.mark.parametrize("n", STAGES)
def test_pipelined_trunk_matches_sequential_and_jax(n, trunks, ranks):
    """Every rank holds the trunk's output and, after the sum over the
    axis, every block's gradient; they equal the port's sequential trunk's
    to 1e-6 and JAX's pipelined trunk's to 1e-5 (of each tensor's largest
    entry); before the sum each block's gradient lies on its owner alone."""
    res = [r["pipeline"] for r in ranks[n]]
    assert all("error" not in r for r in res), [r.get("error") for r in res]
    seq = res[0]["sequential"]["trunk"]
    want_y, want_dx, want_blocks = trunks[n]
    names = [k for k in res[0]["names"] if k.startswith("trunk.")]
    per_stage = -(-TINY["num_rrdb"] // n)
    for p, r in enumerate(res):
        got = r["trunk"]
        _close(got["y"], seq["y"], 1e-6, "y")
        _close(got["y"], _nchw(want_y), 1e-5, "y vs jax")
        _close(got["dx"], seq["dx"], 1e-6, "dx")
        _close(got["dx"], _nchw(want_dx), 1e-5, "dx vs jax")
        for name, owned, g, s in zip(names, got["owned"], got["dtrunk"], seq["dtrunk"]):
            assert owned == (int(name.split(".")[1]) // per_stage == p), (p, name)
            _close(g, s, 1e-6, name)
            _close(g, want_blocks[name], 1e-5, name + " vs jax")
    assert all(np.array_equal(r["trunk"]["y"], res[0]["trunk"]["y"]) for r in res)


@pytest.mark.parametrize("n", STAGES)
def test_pipelined_generator_gradients_match_sequential(n, ranks):
    """``pipelined_generator_apply``'s SR and L1 gradients (the convs
    around the trunk whole on every rank, the trunk's summed over the axis)
    equal the sequential generator's to 1e-6 on every rank."""
    res = [r["pipeline"] for r in ranks[n]]
    seq = res[0]["sequential"]["generator"]
    for r in res:
        _close(r["generator"]["sr"], seq["sr"], 1e-6, "sr")
        for name, g, s in zip(r["names"], r["generator"]["grads"], seq["grads"]):
            _close(g, s, 1e-6, name)


def test_pipe_mesh_step_matches_the_jax_trainer(jax_step, ranks):
    """Two f64 ``bsrnet`` steps on a (2, 2) (data, pipe) mesh: each rank's
    losses, G and EMA-G equal the JAX Trainer's on the same mesh to 1e-9
    (of each tensor's largest entry), the four ranks alike bit for bit; the
    batch of one runs the sequential trunk on both sides and agrees too."""
    res = [r["train"] for r in ranks[4]]
    assert all("error" not in r for r in res), [r.get("error") for r in res]
    assert res[1]["mesh"] == "Mesh({'data': 2, 'pipe': 2}, rank at {'data': 0, 'pipe': 1})"
    assert all(r["pipelined"] == [True, False] for r in res)
    for r in res:
        np.testing.assert_allclose([[m[k] for k in ("pixel_loss", "g_loss")] for m in r["metrics"]],
                                   jax_step["metrics"], rtol=1e-9, atol=0)
        for tree in ("g", "ema"):
            for k, v in r[tree].items():
                assert np.array_equal(v, res[0][tree][k]), (tree, k)
                _close(v, jax_step[tree][k], 1e-9, f"{tree} {k}")
        _close(r["eval"], jax_step["eval"], 1e-9, "eval")


def test_a_pipe_axis_needs_the_scanned_trunk_as_in_jax():
    """A ``pipe`` axis with a generator built without ``scan_blocks``
    raises JAX's ValueError, in a world of one as on JAX's mesh."""
    unscanned = {k: v for k, v in TINY.items() if k != "scan_blocks"}
    with pytest.raises(ValueError) as jax_error:
        JaxTrainer(_pp_config(True, g_kwargs=unscanned), steps_per_epoch=1,
                   mesh=make_mesh(PP_MESH, ("data", "pipe"), devices=jax.devices()[:4]))
    with pytest.raises(ValueError) as port_error:
        Trainer(_pp_config(False, g_kwargs=unscanned, mesh_shape=(1, 1)))
    assert str(port_error.value) == str(jax_error.value)
    Trainer(_pp_config(False, mesh_shape=(1, 1)))
