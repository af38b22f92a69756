"""Time the RDB backward kernels of several checkouts of this repository on
one card, in turns, for a before/after comparison within one run.

    python3 rdb_bwd_study.py ROOT [ROOT ...]

Each ROOT is a checkout (``.`` for this one; an older commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, e.g.
``build/parent``). Give the roots in the order to run them, e.g. ``build/parent
. . build/parent``: a subprocess per root imports that root's
``srganfd_tpu_torch``, builds its ``csrc/rdb_bwd.cu`` into its own
``build/kernels/``, and at each recipe's RDB shape, in bf16 and f32, times
``rdb_backward`` on the same seeded inputs: the card's time a call (CUDA
events over a CUDA graph of 20 calls) and the wrapper's host time a call (50
eager calls, no synchronisation in between). It prints a line per root and
writes all of them, with the card's name and power limit, to
``chiprun_out/rdb_bwd_study.json``. It exits 1 without a CUDA device.
"""

import json
import os
import subprocess
import sys

SHAPES = ((16, 72, 72, 64), (48, 64, 64, 64), (8, 60, 60, 64), (16, 48, 48, 64), (16, 32, 32, 64))
GC = 32

WORKER = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from srganfd_tpu_torch.ops.cuda import rdb

def graph_ms(fn, iters=20):
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

out = {}
for shape in json.loads(sys.argv[2]):
    n, h, w, ch = shape
    gc = int(sys.argv[3])
    g0 = torch.Generator().manual_seed(404)
    x = torch.randn(shape, generator=g0)
    ks = [torch.randn(3, 3, ch + k * gc, gc if k < 4 else ch, generator=g0) / (3 * (ch + k * gc) ** 0.5)
          for k in range(5)]
    bs = [torch.randn(gc if k < 4 else ch, generator=g0) * 0.1 for k in range(5)]
    x, ks, bs = x.cuda(), [k.cuda() for k in ks], [b.cuda() for b in bs]
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        xd = x.to(dt)
        packed = rdb.pack_rdb_weights(ks, bs, dt)
        with torch.no_grad():
            _, feat = rdb.rdb_forward_ref(xd, ks, bs, with_feat=True)
        cot = torch.randn(shape, generator=torch.Generator().manual_seed(405)).cuda().to(dt)
        args = (xd, feat, cot, packed, gc)
        ms = graph_ms(lambda: rdb.rdb_backward(*args))
        for _ in range(3):
            rdb.rdb_backward(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            rdb.rdb_backward(*args)
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        out["x".join(map(str, shape[:3])) + "_" + name] = {"ms": ms, "host_ms": host}
print(json.dumps(out))
"""


def main() -> None:
    roots = sys.argv[1:]
    import torch

    if not torch.cuda.is_available() or not roots:
        sys.exit("rdb_bwd_study.py needs a CUDA device and at least one checkout root")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", WORKER, os.path.abspath(root), json.dumps(SHAPES), str(GC)],
                              capture_output=True, text=True, cwd=os.path.abspath(root))
        if proc.returncode:
            sys.exit(f"{root}: {proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root, "times": res})
        print(root, {k: (round(v["ms"], 4), round(v["host_ms"], 4)) for k, v in res.items()}, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "rdb_bwd_study.json"), "w") as f:
        json.dump({"card": smi, "shapes": SHAPES, "gc": GC, "runs": runs}, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
