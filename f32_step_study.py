"""How far one full-width f32 ``bsrnet`` step moves when only the rounding
of the RDB's forward changes, and whether ``train/step_check.py``'s rule
tells correct forwards from faults.

``chip_smoke.py`` holds one f32 step with the RDB kernel to the same step
with ``rdb_forward_ref`` on one batch (the chain's, with the filter2d
kernel) by the rule of ``srganfd_tpu_torch.train.step_check``. This script
measures what that comparison can see. For several states of G (the seeded
init at three seeds, and G after a few bf16 steps) and two batches each,
it builds the batch once with the kernels, holds its LR to the plain
chain's, and runs one f32 step from the same state on that batch with each
RDB forward below; every backward is the port's (autograd through the
recomputed ``rdb_forward_ref``):

- ``kernels``: the port as it runs (the 3xTF32 RDB kernel);
- ``plain`` and ``plain_again``: ``rdb_forward_ref`` (cuDNN, f32), twice,
  which shows what cuDNN's own run-to-run differences are;
- ``exact``: each conv summed in float64 and rounded to f32 where the f32
  path rounds, the nearest an f32 forward can come to the exact sums;
- ``one_tf32``: ``rdb_forward_ref`` with cuDNN's TF32 on, one TF32 product
  per pair: what the kernel would compute without its split;
- ``bias_grad_fault`` and ``bias_grad_lost``: the kernels, with one trunk
  bias's gradient scaled by 1 + 1e-4, or lost (planted faults of the
  backward).

For each against ``plain`` it reports the loss's difference; the updated
G's largest per-tensor relative difference (``max |dG| / max |G|``) and the
three largest elements of the worst tensor; the step's update (``U``, G
after the step less G before) as a whole (``|dU| / |U|`` in the L2 and the
max norm); the LeakyReLU slope flips that the backward sees in the trunk,
and after it (the upsampling and HR convs' LeakyReLUs, the clamp); and the
readings of ``step_check``'s channel rule (G to 1e-5 outside the excluded
set): G outside and inside it, with the flipped channels alone excluded
(``channels``) and with the biases outside the RDBs too
(``channels_and_outer_biases``), and whether the rule passes; and whether
the limits ``chip_smoke.py`` holds (G to 1e-3) pass.

Run on one CUDA device from the repo root: ``python3 f32_step_study.py``.
It writes ``chiprun_out/f32_step_study.json``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

import chip_smoke
from srganfd_tpu_torch.train import step_check

ROOT = os.path.dirname(os.path.abspath(__file__))
STATES = ("init_seed0", "init_seed1", "init_seed2", "trained")
BATCHES = 2
TRAIN_STEPS = 6  # bf16 steps that make the "trained" state
VARIANTS = ("kernels", "plain_again", "exact", "one_tf32", "bias_grad_fault", "bias_grad_lost")
# what the rule must say of each
CORRECT, FAULTS_SEEN = ("kernels", "plain_again", "exact"), ("one_tf32", "bias_grad_fault", "bias_grad_lost")
REACHES = {"channels": False, "channels_and_outer_biases": True}  # g_agreement's outer
POST_TRUNK = ("upsampling1.0", "conv3.0", "conv4")  # bsrgan_x2's convs after the trunk
# the planted faults: this bias's gradient scaled by (1 + 1e-4), or by 0
FAULT_PARAM, FAULTS = "trunk.12.rdb2.conv3.bias", {"bias_grad_fault": 1 + 1e-4, "bias_grad_lost": 0.0}


def rdb_forward_exact(x, kernels, biases):
    """``rdb_forward_ref`` with each conv summed in float64, rounded to f32
    where the f32 path rounds."""
    x32 = x.float().permute(0, 3, 1, 2)
    feats = [x32]
    for k in range(5):
        w = kernels[k].double().permute(3, 2, 0, 1)
        y = F.conv2d(torch.cat(feats, 1).double(), w, biases[k].double(), padding=1).float()
        if k < 4:
            feats.append(F.leaky_relu(y, 0.2))
    return (y * 0.2 + x32).permute(0, 2, 3, 1)


def rdb_forward_one_tf32(x, kernels, biases):
    """``rdb_forward_ref`` with cuDNN's TF32 on: one TF32 product a pair."""
    from srganfd_tpu_torch.ops.cuda import rdb

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return rdb.rdb_forward_ref(x, kernels, biases)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _OtherForward(torch.autograd.Function):
    """``forward_fn`` forward, the port's backward: autograd through
    ``rdb_forward_ref`` recomputed at the saved input."""

    @staticmethod
    def forward(ctx, forward_fn, x, *params):
        ctx.save_for_backward(x, *params)
        return forward_fn(x, list(params[:5]), list(params[5:]))

    @staticmethod
    def backward(ctx, grad):
        from srganfd_tpu_torch.ops.cuda import rdb

        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, *params)]
            y = rdb.rdb_forward_ref(inputs[0], inputs[1:6], inputs[6:])
            grads = torch.autograd.grad(y, inputs, grad)
        return (None, *grads)


def one_step(cfg, init, batch, variant, rdb, blocks):
    """One f32 step of ``variant`` from ``init`` on ``batch``; returns the
    loss, updated G, each RDB's (input, kernels, biases) and name, and SR."""
    from srganfd_tpu_torch.train.loop import Trainer

    real_apply = blocks.rdb_apply
    forward = {"plain": rdb.rdb_forward_ref, "plain_again": rdb.rdb_forward_ref,
               "exact": rdb_forward_exact, "one_tf32": rdb_forward_one_tf32}.get(variant)
    fault = FAULTS.get(variant)
    seen = []

    def recording(x, k, b, packed=None):
        seen.append((x.detach().clone(), [t.detach().clone() for t in k], [t.detach().clone() for t in b]))
        if forward is None:
            return real_apply(x, k, b, packed)
        if forward is rdb.rdb_forward_ref:
            return forward(x, k, b)  # plain: autograd through it, as chip_smoke.py's plain step
        return _OtherForward.apply(forward, x, *k, *b)

    blocks.rdb_apply = recording
    try:
        trainer = Trainer(cfg, steps_per_epoch=1000, device="cuda")
        state = trainer.init_state(init)
        out = {}
        g0 = {k: v.detach().clone() for k, v in state.g_model.state_dict().items()}
        model = state.g_model
        hooks = [model.register_forward_hook(lambda m, i, o: out.update(sr=o.detach().clone()))]
        # the pre-activations after the trunk: the LeakyReLU inputs of the
        # upsampling and HR convs, and the last conv's output before its clamp
        for name in POST_TRUNK:
            hooks.append(model.get_submodule(name).register_forward_hook(
                lambda m, i, o, name=name: out.update({name: o.detach().clone()})))
        if fault is not None:
            state.g_model.get_parameter(FAULT_PARAM).register_hook(lambda grad: grad * fault)
        before = rdb.launches
        loss = trainer.train_step(state, batch["gt"], batch["lr"])["pixel_loss"].item()
        for hook in hooks:
            hook.remove()
        launched = rdb.launches - before
    finally:
        blocks.rdb_apply = real_apply
    if (launched > 0) != (forward is None):
        raise RuntimeError(f"{variant}: {launched} RDB kernel launches")
    g = {k: v.detach().clone() for k, v in state.g_model.state_dict().items()}
    names = [n for n, m in state.g_model.named_modules() if isinstance(m, blocks.ResidualDenseBlock)]
    return {"gt": batch["gt"], "loss": loss, "g": g, "g0": g0, "rdb_inputs": seen, "rdb_names": names,
            "sr": out["sr"], "post_trunk": [out[name] for name in POST_TRUNK]}


def compare(a: dict, b: dict, lr_max_abs: float) -> dict:
    rel = {k: ((a["g"][k] - b["g"][k]).abs().max() / b["g"][k].abs().max().clamp_min(1e-12)).item()
           for k in b["g"]}
    worst = max(rel, key=rel.get)
    d = (a["g"][worst] - b["g"][worst]).abs().reshape(-1)
    top = torch.topk(d, min(3, d.numel()))
    denom = b["g"][worst].abs().max().item()
    flips, channels = step_check.slope_flips(a["rdb_inputs"], b["rdb_inputs"])
    flipped = step_check.flipped_channels(b["rdb_names"], channels)
    ua = torch.cat([(a["g"][k] - a["g0"][k]).reshape(-1) for k in b["g"]])
    ub = torch.cat([(b["g"][k] - b["g0"][k]).reshape(-1) for k in b["g"]])
    l2 = lambda t: t.double().norm().item()
    r = {
        "update_rel_l2": l2(ua - ub) / l2(ub),
        "update_rel_max": ((ua - ub).abs().max() / ub.abs().max()).item(),
        "lr_max_abs": lr_max_abs,
        "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        "g_max_rel": rel[worst], "g_worst": worst,
        "g_worst_top3_rel": [v / denom for v in top.values.tolist()],
        "g_worst_top3_index": top.indices.tolist(),
        "slope_flips": sum(flips),
        "rdbs_with_flips": sum(f > 0 for f in flips),
        "flipped_convs": sorted(flipped),
        "l1_sign_flips": int(((a["sr"] - a["gt"] > 0) != (b["sr"] - b["gt"] > 0)).sum()),
    }
    # slopes taken differently after the trunk (LeakyReLU at 0; the clamp at
    # 0 and 1), which step_check.slope_flips does not count
    live = lambda z: (z > 0) & (z < 1)
    r["post_trunk_flips"] = [int(((za > 0) != (zb > 0)).sum())
                             for za, zb in zip(a["post_trunk"][:-1], b["post_trunk"][:-1])]
    r["post_trunk_flips"].append(int((live(a["post_trunk"][-1]) != live(b["post_trunk"][-1])).sum()))
    r["post_trunk_flips_total"] = sum(r["post_trunk_flips"])
    for reach, outer in REACHES.items():
        g = step_check.g_agreement(a["g"], b["g"], flipped, outer=outer)
        failed = step_check.step_check_failures({**r, **g}, step_check.CHANNEL_RULE)
        r[reach] = {**g, "failed": failed, "passes": not failed}
    # the limits chip_smoke.py holds (G to 1e-3 everywhere)
    r["passes_held_limits"] = not step_check.step_check_failures({**r, **g}, step_check.LIMITS)
    return r


def main() -> None:
    if not torch.cuda.is_available():
        print("f32_step_study: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.ops import filters
    from srganfd_tpu_torch.ops.cuda import build, rdb
    from srganfd_tpu_torch.ops.cuda import filter2d as f2d
    from srganfd_tpu_torch.train.loop import Trainer

    def chain(cfg, host, seed, plain):
        """The chain's batch, with the filter2d kernel or its plain version."""
        real = filters.filter2d
        filters.filter2d = f2d.filter2d_ref if plain else real
        try:
            return DegradationAdapter(cfg, seed=seed, train=True, device="cuda")(host, 0)
        finally:
            filters.filter2d = real

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    results = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="f32_step_study_", dir=base) as work:
        train_dir = os.path.join(work, "train_gt")
        chip_smoke.write_gt_frames(train_dir, 24, chip_smoke.TRAIN_FRAME, seed=10)
        cfg = configs.get_config("bsrnet").replace(train_gt_images_dir=train_dir, valid_gt_images_dir=train_dir,
                                                   results_dir=os.path.join(work, "results"))
        dataset = cli_train.build_datasets(cfg)[0]
        hosts = []
        for b in range(BATCHES + TRAIN_STEPS):
            it = iter(BatchLoader(dataset, cfg.batch_size, seed=cfg.seed + b, num_workers=2))
            hosts.append(next(it))
            it.close()
        f32 = cfg.replace(compute_dtype="float32")
        for state_name in STATES:
            if state_name == "trained":  # bf16 steps with the kernels, then f32 from there
                trainer = Trainer(cfg, steps_per_epoch=1000, device="cuda")
                st = trainer.init_state()
                for s in range(TRAIN_STEPS):
                    batch = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")(
                        hosts[BATCHES + s], s)
                    trainer.train_step(st, batch["gt"], batch["lr"])
                init = {k: v.detach().clone() for k, v in st.g_model.state_dict().items()}
                del trainer, st
                step_cfg = f32
            else:
                init, step_cfg = None, f32.replace(seed=cfg.seed + int(state_name[-1]))
            for b in range(BATCHES):
                batch = chain(step_cfg, hosts[b], cfg.seed + b, plain=False)
                lr_max_abs = (batch["lr"] - chain(step_cfg, hosts[b], cfg.seed + b, plain=True)["lr"]).abs().max().item()
                runs = {v: one_step(step_cfg, init, batch, v, rdb, blocks) for v in ("plain", *VARIANTS)}
                for v in VARIANTS:
                    r = {"state": state_name, "batch": b, "variant": v, **compare(runs[v], runs["plain"], lr_max_abs)}
                    results.append(r)
                    print(json.dumps(r), flush=True)
                del runs, batch
                torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    stats = ("g_max_rel", "update_rel_l2", "update_rel_max", "slope_flips", "post_trunk_flips_total", "loss_rel",
             "lr_max_abs")
    summary = {v: {s: [f(r[s] for r in results if r["variant"] == v) for f in (min, max)] for s in stats}
               for v in VARIANTS}
    for v in VARIANTS:
        for reach in REACHES:
            mine = [r[reach] for r in results if r["variant"] == v]
            summary[v][reach] = {
                "passes": sum(m["passes"] for m in mine), "cases": len(mine),
                "g_outside": [min(m["g_outside"] for m in mine), max(m["g_outside"] for m in mine)],
                "g_inside": [min(m["g_inside"] for m in mine), max(m["g_inside"] for m in mine)],
            }
        summary[v]["passes_held_limits"] = sum(r["passes_held_limits"] for r in results if r["variant"] == v)
    # the rule separates when it passes every correct case and fails every fault
    verdict = {reach: all(summary[v][reach]["passes"] == summary[v][reach]["cases"] for v in CORRECT)
               and all(summary[v][reach]["passes"] == 0 for v in FAULTS_SEEN) for reach in REACHES}
    print(f"each variant against the plain step over {len(STATES)} states x {BATCHES} batches, [least, "
          f"largest] ({time.perf_counter() - t0:.0f} s):")
    for v in VARIANTS:
        print(f"  {v}: {summary[v]}")
    print(f"the rule separates correct forwards from faults: {verdict}")
    print(smi)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "f32_step_study.json"), "w") as f:
        json.dump({"device": smi, "results": results, "summary": summary, "separates": verdict}, f, indent=1)


if __name__ == "__main__":
    main()
