"""How the f32 ``esrgan`` check of ``chip_smoke.py`` reads across trainings.

``chip_smoke.py``'s ``es_train_phase`` trains ``rrdbnet`` and then
``esrgan`` (the configs unchanged) and holds one f32 ``esrgan`` step with
the RDB kernel to the same step with ``rdb_forward_ref``, D per tensor.
Training on the card is not bitwise repeatable, so each run starts that
step from another trained state. This script runs the phase N times (3 by
default), each from a fresh training on fresh frames, with the phase's
checks recorded instead of ending the run, and writes, for each run, every
per-tensor relative difference the phase read (``max |a - b| / max |b|``,
in the order the phase reads them), the checks that failed and the f32
readings to ``chiprun_out/es_check_study.json``.

    python3 es_check_study.py [N]

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


def main(n: int) -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this study needs a GPU")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rels, failures, real_rel = [], [], cs._rel_per_tensor

    def recorded_rel(a, b):
        rels.append({k: (a[k].float() - v.float()).abs().max().item() / max(v.float().abs().max().item(), 1e-12)
                     for k, v in b.items()})
        return real_rel(a, b)

    def recorded_check(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"check failed: {msg}", flush=True)

    cs._rel_per_tensor, cs.check = recorded_rel, recorded_check
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs = []
    for i in range(n):
        rels.clear()
        failures.clear()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="es_study_", dir=os.path.join(ROOT, "build")) as work:
            cs.write_gt_frames(os.path.join(work, "train_gt"), 24, cs.TRAIN_FRAME, seed=10)
            cs.write_gt_frames(os.path.join(work, "valid_gt"), 4, cs.TRAIN_FRAME, seed=11)
            try:
                f32 = cs.es_train_phase(work, rdb, f2d, blocks, filters)[1]["esrgan"]["f32_step_vs_plain"]
            except Exception:
                traceback.print_exc()
                failures.append("raised")
                f32 = None
        runs.append({"run": i, "s": time.perf_counter() - t, "failures": list(failures), "rels": list(rels),
                     "f32": f32})
        with open(os.path.join(out_dir, "es_check_study.json"), "w") as f:
            json.dump(runs, f, default=str)
        print(f"run {i}: {time.perf_counter() - t:.1f} s, failed checks {failures}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
