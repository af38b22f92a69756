"""How the f32 ``aesrgan`` check of ``chip_smoke.py`` reads across trainings.

``chip_smoke.py``'s ``ae_train_phase`` trains ``aesrgan`` (the config
unchanged) and holds one f32 step with the RDB kernel to the same step
with ``rdb_forward_ref``: D per tensor, its gradients, the plain step run
twice bit for bit. Training on the card is not bitwise repeatable, so each
run starts that step from another trained state. This script runs the
phase N times (4 by default), each from a fresh training on fresh frames,
with the phase's checks recorded instead of ending the run. At each
trained state it takes the f32 step again (kernel and plain) with each of
PLANTED's faults in the kernel run: the RDB's residual branch, the
kernel's output less its input, scaled by (1 + f). For the phase's step
and each planted one it writes every D tensor's relative difference of
value and of gradient (``max |a - b| / max |b|``), the loss parts and G's
readings, to ``chiprun_out/ae_check_study.json``.

    python3 ae_check_study.py [N]

It needs one CUDA card and builds the kernels from ``srganfd_tpu_torch/csrc``.
"""

import json
import os
import sys
import tempfile
import time
import traceback

import torch

import chip_smoke as cs
from srganfd_tpu_torch.models import blocks
from srganfd_tpu_torch.ops import filters
from srganfd_tpu_torch.ops.cuda import build, rdb
from srganfd_tpu_torch.ops.cuda import filter2d as f2d

ROOT = os.path.dirname(os.path.abspath(__file__))
BIAS = "conv0.bias"


def per_tensor(a: dict, b: dict) -> dict:
    return {k: (a[k].float() - v.float()).abs().max().item() / max(v.float().abs().max().item(), 1e-12)
            for k, v in b.items() if v.is_floating_point() and not k.endswith(".u")}


PLANTED = (1e-6, 1e-5, 1e-4)


def main(n: int) -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this study needs a GPU")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures, steps = [], []
    real_step = cs.f32_step_vs_plain

    def recorded_check(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"check failed: {msg}", flush=True)

    def readings(r: dict, runs: list, planted: float) -> dict:
        (_, _, d_k), (_, _, d_p) = runs[:2]
        return {"planted": planted, "d_value": per_tensor(d_k, d_p), "d_grad": r["d_grad_rel_parts"],
                "loss_rel": r["loss_rel_parts"], "g_outside": r["g_outside"], "g_inside": r["g_inside"],
                "slope_flips": r["slope_flips"], "nondeterministic_ops": r.get("nondeterministic_ops")}

    def studied_step(cfg, host, *args, label="", **kw):
        result = real_step(cfg, host, *args, label=label, **kw)
        if not label.startswith("aesrgan"):
            return result
        steps.append(readings(*result, 0.0))
        kw.update(plain_runs=1)
        for f in PLANTED:
            kernel = blocks.rdb_apply

            def planted(x, k, b, packed=None, f=f, kernel=kernel):
                return x + (kernel(x, k, b, packed) - x) * (1 + f)

            blocks.rdb_apply = planted
            try:
                steps.append(readings(*real_step(cfg, host, *args, label=f"{label}, planted {f:g}", **kw), f))
            finally:
                blocks.rdb_apply = kernel
        for s in steps:
            vals = {k: v for k, v in s["d_value"].items() if not k.endswith(("W.0.bias", "running_mean",
                                                                              "running_var"))}
            grads = {k: v for k, v in s["d_grad"].items() if not k.endswith("W.0.bias")}
            print(f"planted {s['planted']:g}: D value worst {max(vals.items(), key=lambda kv: kv[1])}, "
                  f"{BIAS} {vals[BIAS]:.3g}; D gradient worst {max(grads.items(), key=lambda kv: kv[1])}, "
                  f"{BIAS} {grads[BIAS]:.3g}; losses {max(s['loss_rel'].values()):.3g}; G outside "
                  f"{s['g_outside']:.3g}", flush=True)
        return result

    cs.check, cs.f32_step_vs_plain = recorded_check, studied_step
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs = []
    for i in range(n):
        failures.clear()
        steps.clear()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="ae_study_", dir=os.path.join(ROOT, "build")) as work:
            cs.write_gt_frames(os.path.join(work, "train_gt"), 24, cs.TRAIN_FRAME, seed=10)
            cs.write_gt_frames(os.path.join(work, "valid_gt"), 4, cs.TRAIN_FRAME, seed=11)
            try:
                f32 = cs.ae_train_phase(work, rdb, f2d, blocks, filters)[1].get("f32_step_vs_plain")
            except Exception:
                traceback.print_exc()
                failures.append("raised")
                f32 = None
        runs.append({"run": i, "s": time.perf_counter() - t, "failures": list(failures), "steps": list(steps),
                     "f32": f32})
        with open(os.path.join(out_dir, "ae_check_study.json"), "w") as f:
            json.dump(runs, f, default=str)
        print(f"run {i}: {time.perf_counter() - t:.1f} s, failed checks {failures}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
