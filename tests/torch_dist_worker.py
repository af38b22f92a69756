"""One rank of the port's distributed CPU tests, and the launcher that
starts them (the counterpart of ``tests/mp_worker.py`` for JAX).

``run_ranks(world, cases, tmp)`` starts ``world`` processes of this file,
each with ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` set, on
a free local port. Each joins a gloo group through the port's
``maybe_init_distributed`` (the ``cpu`` device), runs every case of the
pickled list in order, and pickles ``{case name: result}``; a case that
raises records ``{"error": "<type>: <message>"}`` and the rank goes on
(every rank raises alike, so no rank is left in a collective). Each
process has a timeout, and the launcher kills the group on the first
failure. Results come back as one dict per rank.

A case is ``(name, function name, kwargs)``, the function one of this
file's ``case_*``.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, cases: list, tmp, timeout: float = 150.0, group_timeout: float = 120.0) -> list[dict]:
    """Run ``cases`` on ``world`` gloo CPU ranks; one result dict per rank.
    ``group_timeout`` is the group's: a collective that waits longer fails."""
    tmp = str(tmp)
    spec = os.path.join(tmp, f"cases_{world}.pkl")
    with open(spec, "wb") as f:
        pickle.dump(cases, f)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=ROOT + os.pathsep + HERE,
                   OMP_NUM_THREADS="1", GROUP_TIMEOUT_S=str(group_timeout))
        err = open(os.path.join(tmp, f"rank{r}_{world}.err"), "w")
        procs.append((subprocess.Popen([sys.executable, __file__, spec, tmp], env=env, cwd=tmp,
                                       stdout=err, stderr=subprocess.STDOUT), err))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.05)
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            err.close()
    logs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}_{world}.err")) as f:
            logs.append(f.read())
    rcs = [p.returncode for p, _ in procs]
    if any(rcs):
        raise RuntimeError(f"ranks exited {rcs} (timeout {timeout} s):\n" + "\n".join(
            f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"result{r}_{world}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- cases ------------------------------------------------------------------------------


def _model(arch, kwargs, state):
    import torch

    from srganfd_tpu_torch.models import create_model

    model = create_model(arch, **kwargs)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.eval().requires_grad_(False)


def case_spatial(arch, kwargs, state, image, halo, row_multiple=1, cp=None):
    """``spatial_sharded_sr`` of a tiny generator on this rank, and on rank
    0 the one-process loop of the same shards (bit-equality in one
    process)."""
    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.parallel.spatial import spatial_sharded_sr, spatial_sr_loop

    if cp is not None:
        kwargs = {**kwargs, "ring_axis": "data", "ring_halo": halo, "cp_backend": cp}
    model = _model(arch, kwargs, state)
    got = spatial_sharded_sr(model, image, model.upscale, halo=halo, row_multiple=row_multiple)
    out = {"sr": got}
    if comm.rank() == 0:
        shards_fn = model.forward_shards if cp is not None else None
        out["loop"] = spatial_sr_loop(model, image, model.upscale, comm.world(), halo=halo,
                                      row_multiple=row_multiple, shards_fn=shards_fn)
    return out


def case_attention(backend, q, k, v, kv_valid=None):
    """Ring or Ulysses attention on this rank's slice of the token axis;
    rank 0 adds the one-process loop over every slice."""
    import torch

    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_loop
    from srganfd_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_loop

    n, r = comm.world(), comm.rank()
    t = q.shape[1] // n
    sl = lambda a: torch.from_numpy(a[:, r * t:(r + 1) * t].copy())  # noqa: E731
    mask = None if kv_valid is None else torch.from_numpy(kv_valid[r * t:(r + 1) * t].copy())
    fn, loop = ((ring_attention, ring_attention_loop) if backend == "ring"
                else (ulysses_attention, ulysses_attention_loop))
    out = {"out": fn(sl(q), sl(k), sl(v), mask).numpy()}
    if r == 0:
        parts = lambda a: [torch.from_numpy(a[:, i * t:(i + 1) * t].copy()) for i in range(n)]  # noqa: E731
        masks = None if kv_valid is None else [torch.from_numpy(kv_valid[i * t:(i + 1) * t].copy()) for i in range(n)]
        out["loop"] = [o.numpy() for o in loop(parts(q), parts(k), parts(v), masks)]
    return out


def case_dp_train(name, overrides, init, d_init, gts, lrs, plant=None):
    """``Trainer.train_step`` on this rank's half of each global batch, from
    the given state, in f64; ``plant`` switches off one of the global
    reductions in this process (``"bn"``: BatchNorm's statistics per rank,
    ``"rel"``: the relativistic means per rank). Returns the metrics of
    each step and the final G, EMA-G and D."""
    import torch

    from srganfd_tpu_torch.losses import gan
    from srganfd_tpu_torch.models.blocks import BatchNorm

    real = BatchNorm.__dict__["_batch_moments"], gan.batch_mean
    try:
        if plant == "bn":
            BatchNorm._batch_moments = staticmethod(lambda xs: (xs.mean((0, 2, 3)), (xs * xs).mean((0, 2, 3))))
        elif plant == "rel":
            gan.batch_mean = torch.mean
        return _dp_train(name, overrides, init, d_init, gts, lrs)
    finally:
        BatchNorm._batch_moments, gan.batch_mean = real


def _dp_train(name, overrides, init, d_init, gts, lrs):
    import torch

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.train.loop import Trainer

    cfg = configs.get_config(name, **overrides)
    tr = Trainer(cfg, steps_per_epoch=1)
    t = lambda d: None if d is None else {k: torch.from_numpy(v.copy()) for k, v in d.items()}  # noqa: E731
    st = tr.init_state(t(init), t(d_init))
    st.g_model.double()
    st.ema_g = {k: v.double() for k, v in st.ema_g.items()}
    if st.d_model is not None:
        st.d_model.double()
    n, r = comm.world(), comm.rank()
    b = gts.shape[1] // n
    metrics = []
    for i in range(gts.shape[0]):
        m = tr.train_step(st, torch.from_numpy(gts[i, r * b:(r + 1) * b].copy()),
                          torch.from_numpy(lrs[i, r * b:(r + 1) * b].copy()))
        metrics.append({k: float(v) for k, v in m.items()})
    np_ = lambda d: {k: v.detach().numpy().copy() for k, v in d.items()}  # noqa: E731
    return {"metrics": metrics, "g": np_(dict(st.g_model.named_parameters())), "ema": np_(st.ema_g),
            "d": None if st.d_model is None else np_(st.d_model.state_dict()), "step": st.step}


def case_data(seed, flags):
    """This rank's ``_resolve_shard("auto")``, its adapter's first draws of
    a few steps, and ``FlagConsensus.poll`` over ``flags[rank]``."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import _resolve_shard
    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.parallel.mesh import FlagConsensus

    adapter = DegradationAdapter(configs.get_config("bsrgan"), seed=seed)
    consensus = FlagConsensus()
    return {
        "shard": _resolve_shard("auto"),
        "draws": [adapter.step_rng(s).integers(0, 2**31, 4).tolist() for s in range(3)],
        "polls": [consensus.poll(f) for f in flags[comm.rank()]],
    }


def _after(idle_s, lines):
    """``lines`` as a stream that gives its first line after ``idle_s``
    seconds (a client that waits before its first request)."""
    time.sleep(idle_s)
    for line in lines:
        yield line + "\n"


def case_cli(module, argv, tiny, stdin_lines=None, idle_s=0.0, keepalive_s=None):
    """``main(argv)`` of ``srganfd_tpu_torch.cli.<module>`` with the CLI's
    models built at the tiny widths ``tiny``; rank 0 reads ``stdin_lines``,
    the first after ``idle_s`` seconds. ``keepalive_s`` replaces the
    serving daemon's ``KEEPALIVE_S``. Returns what the rank printed."""
    import importlib

    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.parallel import comm

    real = infer.create_model
    infer.create_model = lambda arch, **kw: real(arch, **{**kw, **tiny})
    mod = importlib.import_module(f"srganfd_tpu_torch.cli.{module}")
    if keepalive_s is not None:
        mod.KEEPALIVE_S = keepalive_s
    if stdin_lines is not None and comm.rank() == 0:
        sys.stdin = _after(idle_s, stdin_lines)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    return {"stdout": out.getvalue()}


def main() -> None:
    spec, tmp = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    from srganfd_tpu_torch.parallel.mesh import maybe_init_distributed

    if not maybe_init_distributed("cpu", timeout_s=float(os.environ["GROUP_TIMEOUT_S"])):
        raise SystemExit("no process group: RANK and WORLD_SIZE are unset")
    with open(spec, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, fn, kwargs in cases:
        try:
            results[name] = globals()[f"case_{fn}"](**kwargs)
        except (Exception, SystemExit) as e:  # noqa: BLE001 - recorded for the test to read
            results[name] = {"error": f"{type(e).__name__}: {e}"}
    rank = int(os.environ["RANK"])
    with open(os.path.join(tmp, f"result{rank}_{os.environ['WORLD_SIZE']}.pkl"), "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
