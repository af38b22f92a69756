"""Data parallelism of the port on two gloo CPU ranks against the JAX
package's data-parallel step.

The ranks are subprocesses (``tests/torch_dist_worker.py``), each with a
timeout. The JAX side runs here, on a 2-device ``data`` mesh of the
virtual CPU devices: its step is one program over the globally sharded
batch. Each rank of the port steps on its half of the same global batch
from the same converted state, in f64 as ``tests/test_torch_esrgan_lockstep.py``
runs its lockstep, and is held to 1e-9 after two steps: ``bsrnet``
(L1 only: the gradient average), ``bsrgan`` (the D step first, against
the spectrally normalised U-Net D: D's averaged update, then G's gradient
through it, and the power iterations' ``u``) and ``esrgan`` (the G step
first, relativistic, against the VGG-128 D with BatchNorm: the gradient
average, BatchNorm's global statistics and the relativistic losses'
global means). The content losses are off: their VGG19 emits f32
features under f64 compute (``tests/test_torch_gan_lockstep.py``).
Planted faults, each global reduction switched off in turn in the ranks'
own copy of the step, miss the JAX step by far more.

Also the data layer: ``_resolve_shard("auto")`` and the adapter's rank key
against JAX's ``(jax.process_index(), jax.process_count())``, and
``FlagConsensus``'s one-poll delay.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.cli import degrade_adapter as jax_adapter
from srganfd_tpu.data import datasets as jax_datasets
from srganfd_tpu.parallel import FlagConsensus as JaxFlagConsensus
from srganfd_tpu.parallel import make_mesh
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu.train.state import GanTrainState
from srganfd_tpu_torch.convert import discriminator_flax_to_state_dict, flax_to_state_dict
from test_torch_esrgan_lockstep import KEYS, LOGIT_BIAS, ROUNDOFF_BOUND, _d_state, _jax_state_in_f64
from torch_dist_worker import run_ranks
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

WORLD = 2
N_STEPS = 2
TINY_G = {"bsrnet": {"channels": 16, "growth_channels": 8, "num_rrdb": 2},
          "esrgan": {"channels": 16, "growth_channels": 8, "num_blocks": 2}}
TINY_G["bsrgan"] = TINY_G["bsrnet"]
CONFIGS = ("bsrnet", "bsrgan", "esrgan")
OVER = {
    "bsrnet": dict(compute_dtype="float64", epochs=4, g_kwargs=TINY_G["bsrnet"]),
    "bsrgan": dict(compute_dtype="float64", epochs=4, g_kwargs=TINY_G["bsrgan"], d_kwargs={"channels": 8},
                   content_weight=()),
    "esrgan": dict(compute_dtype="float64", epochs=4, g_kwargs=TINY_G["esrgan"], d_kwargs={"channels": 8},
                   content_weight=()),
}
GT = {"bsrnet": 32, "bsrgan": 32, "esrgan": 128}
SF = {"bsrnet": 2, "bsrgan": 2, "esrgan": 4}
KEYS = {**KEYS, "bsrnet": ("pixel_loss", "g_loss"),
        "bsrgan": ("d_loss", "d_gt_probability", "d_sr_probability", "pixel_loss", "adversarial_loss", "g_loss")}
PLANTS = ("bn", "rel")
# the data layer's checks: per-rank flags for FlagConsensus, equal on all
# ranks in the first list (JAX's one process can only pose that case)
EQUAL_FLAGS = [0, 2, 0, 7, 0]
MIXED_FLAGS = [[0, 0, 3, 0, 0], [0, 5, 0, 0, 0]]
CLI_FRAMES = 3  # shards of 2 and 1 frames: one step an epoch on both ranks at batch 1


def _filled(tree_shapes, seed):
    """A variable tree of ``jax.eval_shape``'s shapes filled from a numpy
    seed (no eager init runs: the G's forward in init costs seconds here):
    kernels N(0, 1/fan_in); the spectral norms' power-iteration vectors
    ``u`` unit normal; the rest as Flax initialises it, biases, BatchNorm
    shifts and running means 0, scales and running variances 1 (the logit's
    bias starts at 0, as ``tests/test_torch_esrgan_lockstep.py`` holds it)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "u":
            u = rng.normal(size=s.shape)
            return u / np.linalg.norm(u)
        return np.full(s.shape, 1.0 if name in ("scale", "var") else 0.0)

    return jax.tree_util.tree_map_with_path(lambda p, s: jnp.asarray(draw(p, s), jnp.float32), tree_shapes)


def _d_tree(name, params, d_vars):
    """The JAX D's variables as the port's state dict: the U-Net D's with
    its ``u`` vectors, the VGG-128 D's with its running statistics."""
    if name == "bsrgan":
        return discriminator_flax_to_state_dict(params, d_vars["spectral"])
    return _d_state(params, d_vars)


def _init_state(jtr, name):
    """The JAX trainer's fresh state, its variables from :func:`_filled`."""
    gt_size, sf = GT[name], SF[name]
    lr = jnp.zeros((2, gt_size // sf, gt_size // sf, 3))
    g = _filled(jax.eval_shape(jtr.g_model.init, jax.random.PRNGKey(0), lr)["params"], 1)
    d_params = d_vars = d_opt = None
    if jtr.d_model is not None:
        dv = _filled(jax.eval_shape(jtr.d_model.init, jax.random.PRNGKey(1),
                                    jnp.zeros((2, gt_size, gt_size, 3))), 2)
        d_params, d_vars = dv["params"], {k: v for k, v in dv.items() if k != "params"}
        d_opt = jtr.d_tx.init(d_params)
    return GanTrainState(step=jnp.zeros((), jnp.int32), g_params=g, g_opt_state=jtr.g_tx.init(g),
                         ema_g_params=jax.tree_util.tree_map(jnp.copy, g), d_params=d_params,
                         d_opt_state=d_opt, d_vars=d_vars)


def _pairs(name):
    gt_size, sf = GT[name], SF[name]
    gts = np.random.default_rng(11).uniform(size=(N_STEPS, 2 * WORLD, gt_size, gt_size, 3))
    gts = gts.astype(np.float32).astype(np.float64)
    return gts, np.ascontiguousarray(gts[:, :, ::sf, ::sf, :])


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX data-parallel steps of both configs and their initial states."""
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    rep, batch = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    runs = {}
    for name in CONFIGS:
        jtr = JaxTrainer(jax_configs.get_config(name, **OVER[name]), steps_per_epoch=1)
        jst = _jax_state_in_f64(jtr, _init_state(jtr, name))
        gan = name != "bsrnet"
        init = {k: np.array(v) for k, v in flax_to_state_dict(jst.g_params).items()}
        d_init = {k: np.array(v) for k, v in _d_tree(name, jst.d_params, jst.d_vars).items()} if gan else None
        jst = jax.device_put(jst, rep)
        gts, lrs = _pairs(name)
        metrics = []
        for i in range(N_STEPS):
            jst, m = jtr.train_step(jst, jax.device_put(jnp.asarray(gts[i]), batch),
                                    jax.device_put(jnp.asarray(lrs[i]), batch))
            metrics.append([float(m[k]) for k in KEYS[name]])
        trees = {"g": flax_to_state_dict(jst.g_params), "ema": flax_to_state_dict(jst.ema_g_params)}
        if gan:
            trees["d"] = _d_tree(name, jst.d_params, jst.d_vars)
        runs[name] = {"init": init, "d_init": d_init, "metrics": metrics,
                      "trees": {t: {k: np.asarray(v) for k, v in d.items()} for t, d in trees.items()}}
    return runs


@pytest.fixture(scope="module")
def dp(jax_runs, tmp_path_factory):
    cases = []
    for name in CONFIGS:
        gts, lrs = _pairs(name)
        run = jax_runs[name]
        kw = dict(name=name, overrides=OVER[name], init=run["init"], d_init=run["d_init"], gts=gts, lrs=lrs)
        cases.append((name, "dp_train", kw))
        if name == "esrgan":
            cases += [(f"esrgan_{p}", "dp_train", {**kw, "plant": p}) for p in PLANTS]
    cases.append(("equal", "data", {"seed": 5, "flags": [EQUAL_FLAGS] * WORLD}))
    cases.append(("mixed", "data", {"seed": 5, "flags": MIXED_FLAGS}))
    esrgan = next(kw for name, _, kw in cases if name == "esrgan")
    cases.append(("accum", "dp_train", {**esrgan, "overrides": {**OVER["esrgan"], "grad_accum_steps": 2}}))
    root = tmp_path_factory.mktemp("dp_cli")
    frames = root / "frames"
    frames.mkdir()
    for i in range(CLI_FRAMES):
        cv2.imwrite(str(frames / f"f{i}.png"),
                    (np.random.default_rng(i).uniform(size=(40, 40, 3)) * 255).astype(np.uint8))
    cases.append(("cli", "cli", {"module": "train", "tiny": {}, "argv": [
        "--config", "bsrnet", "--device-type", "cpu", "--tiny", "--train-dir", str(frames),
        "--valid-dir", str(frames), "--gt-size", "24", "--batch-size", "1", "--epochs", "1"]}))
    run_dir = tmp_path_factory.mktemp("dp")  # the ranks' working directory
    return {"ranks": run_ranks(WORLD, cases, run_dir, timeout=240), "run_dir": str(run_dir)}


def _offs(got: dict, want: dict) -> dict:
    """Per tensor: |got - want| max over |want| max."""
    assert set(got) == set(want)
    return {k: np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30) for k in want}


@pytest.mark.parametrize("name", CONFIGS)
def test_dp_step_matches_the_jax_data_parallel_step(name, jax_runs, dp):
    """Both ranks end with the same state, and it is the JAX step's: the
    losses (the ranks' mean) to 1e-9 relative, G, EMA-G and D (weights,
    BatchNorm scales, running statistics) to 1e-9 of each tensor's largest
    entry, but the two D biases whose gradient is roundoff
    (``tests/test_torch_esrgan_lockstep.py``): ``classifier.0.bias`` to
    1e-8, the logit's bias by its value below 1e-7 lr."""
    run = jax_runs[name]
    got = [r[name] for r in dp["ranks"]]
    assert all("error" not in g for g in got), [g.get("error") for g in got]
    assert [g["step"] for g in got] == [N_STEPS] * WORLD
    for g in got:
        np.testing.assert_allclose([[m[k] for k in KEYS[name]] for m in g["metrics"]], run["metrics"],
                                   rtol=1e-9, atol=0)
    for tree in ("g", "ema", "d"):
        if got[0][tree] is None:
            continue
        for k in got[0][tree]:  # the ranks agree bit for bit
            assert np.array_equal(got[0][tree][k], got[1][tree][k]), (tree, k)
        for k, off in _offs(got[0][tree], run["trees"][tree]).items():
            if tree == "d" and k == LOGIT_BIAS:
                assert max(np.abs(got[0][tree][k]).max(), np.abs(run["trees"][tree][k]).max()) <= 1e-11
                continue
            assert off <= (ROUNDOFF_BOUND.get(k, 1e-9) if tree == "d" else 1e-9), (tree, k, off)


@pytest.mark.parametrize("plant", PLANTS)
def test_each_global_reduction_is_needed(plant, jax_runs, dp):
    """With BatchNorm's statistics (``bn``) or the relativistic means
    (``rel``) taken per rank, the esrgan step misses the JAX step by far
    more than the 1e-9 the synced step holds: 1e-5 at least on some tensor
    of D and on the losses."""
    got = dp["ranks"][0][f"esrgan_{plant}"]
    assert "error" not in got, got
    run = jax_runs["esrgan"]
    worst = max(off for k, off in _offs(got["d"], run["trees"]["d"]).items() if k != LOGIT_BIAS)
    loss_off = np.abs(np.array([[m[k] for k in KEYS["esrgan"]] for m in got["metrics"]])
                      - np.array(run["metrics"])).max()
    assert worst > 1e-5 and loss_off > 1e-6, (worst, loss_off)


def test_resolve_shard_auto_is_the_ranks_shard_as_in_jax(dp, monkeypatch):
    """``"auto"`` is ``(rank, world)`` on each rank, JAX's
    ``(process_index, process_count)``; the lists it keeps split the files
    as JAX's do."""
    for r, res in enumerate(dp["ranks"]):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        assert res["equal"]["shard"] == jax_datasets._resolve_shard("auto") == (r, WORLD)


def test_adapter_keys_its_draws_by_rank_as_jax(dp, monkeypatch):
    """Each rank's step RNG is the JAX adapter's on the process of that
    index: rank 0's is the one-process run's, rank 1's differs."""
    cfg = jax_configs.get_config("bsrgan")
    ranks = dp["ranks"]
    for r, res in enumerate(ranks):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = [jax_adapter.DegradationAdapter(cfg, seed=5).step_rng(s).integers(0, 2**31, 4).tolist()
                for s in range(3)]
        assert res["equal"]["draws"] == want
    assert ranks[0]["equal"]["draws"] != ranks[1]["equal"]["draws"]


def test_flag_consensus_answers_one_poll_late(dp):
    """Each poll returns the max over the ranks of the previous round's
    flags (0 first): with equal flags JAX's ``FlagConsensus`` over two
    devices answers the same sequence; with a flag on one rank only, every
    rank sees it one poll later."""
    ranks = dp["ranks"]
    jax_flags = JaxFlagConsensus(jax.devices()[:WORLD])
    want = [jax_flags.poll(f) for f in EQUAL_FLAGS]
    assert want == [0] + EQUAL_FLAGS[:-1]
    assert [r["equal"]["polls"] for r in ranks] == [want] * WORLD
    rounds = np.max(MIXED_FLAGS, axis=0).tolist()
    assert [r["mixed"]["polls"] for r in ranks] == [[0] + rounds[:-1]] * WORLD


def test_accumulation_with_global_statistics_is_refused_under_dp(dp):
    """``grad_accum_steps`` > 1 on ``esrgan`` (BatchNorm D, relativistic)
    under data parallelism raises, naming A11: the JAX step's chunks are
    slices of the global batch, whose statistics no rank holds."""
    errors = {r["accum"].get("error", "") for r in dp["ranks"]}
    assert len(errors) == 1 and "NotImplementedError" in errors.pop()


def test_cli_train_on_two_ranks(dp):
    """``cli.train`` under a gloo group of 2: both ranks take the same
    number of steps though their shards differ (2 and 1 frames: the min
    over the ranks, 1 step), report the same averaged loss, and only rank
    0 writes the checkpoints and the tracker's events."""
    outs = [r["cli"] for r in dp["ranks"]]
    assert all("error" not in o for o in outs), outs
    for r, o in enumerate(outs):
        assert f"data parallel: rank {r} of 2 (gloo)" in o["stdout"], o["stdout"]
    losses = [[ln.split("G loss")[1].split()[0] for ln in o["stdout"].splitlines() if "G loss" in ln] for o in outs]
    assert losses[0] == losses[1] and len(losses[0]) == 1
    from srganfd_tpu_torch.train import checkpoint as ckpt

    found = [os.path.join(d, f) for d, _, fs in os.walk(dp["run_dir"]) for f in fs if f.endswith(".pth")]
    assert sorted(os.path.basename(f) for f in found) == ["ckpt_best.pth", "ckpt_last.pth"]
    assert ckpt.load_checkpoint([f for f in found if f.endswith("ckpt_last.pth")][0])["step"] == 1
    events = [os.path.join(d, f) for d, _, fs in os.walk(dp["run_dir"]) for f in fs if f == "events.jsonl"]
    assert len(events) == 1
    with open(events[0]) as f:
        steps = [ln for ln in f if '"Train/' in ln]
    assert len(steps) == 1  # rank 0's one print step, not rank 1's too
