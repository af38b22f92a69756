"""Time the port's bf16 tensor-core kernels of several checkouts of this
repository on one card, in turns, for a before/after comparison within one
run; or read the kernels' clock64 phase counters.

    python3 rdb_bwd_study.py [--mode backward|forward|flash|probe] ROOT [ROOT ...]

Each ROOT is a checkout (``.`` for this one; an older commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, e.g.
``build/parent``). Give the roots in the order to run them, e.g. ``build/parent
. . build/parent``: a subprocess per root imports that root's
``srganfd_tpu_torch``, builds its kernels into its own ``build/kernels/``,
and times them on the same seeded inputs: the card's time a call (CUDA
events over a CUDA graph of 20 calls) and the wrapper's host time a call (50
eager calls, no synchronisation in between).

- ``backward`` (the default): ``rdb_backward`` at each recipe's RDB shape,
  bf16 and f32 (``csrc/rdb_bwd.cu``).
- ``forward``: ``rdb_forward`` in bf16 at the serving shape (1, 256, 256,
  64) and each recipe's RDB shape (``csrc/rdb.cu``).
- ``flash``: ``flash_attention`` in bf16 at the serving shape of
  ``bsrgantrans_x2`` (1, 16384, 4, 16) and at D = 32, with
  ``scaled_dot_product_attention`` on the same inputs in the same process
  (``csrc/flash_attention.cu``).
- ``probe``: each root's ``rdb.cu`` and ``flash_attention.cu`` built again
  with ``-DSRGANFD_PROBE`` (a library apart), run at the forward's and
  flash's shapes; the kernels' clock64 counters, summed over their consumer
  warpgroups, give each pixel or key tile's cycles waiting for its copies,
  in its products and in its epilogue (flash: S's products, the softmax,
  then P V's issue), and the producer's cycles waiting for a free slot; each RDB
  block's cycles copying its weights and then waiting for the launch before
  it to complete; and the SM clock (``nvidia-smi``, sampled while flash runs
  for 2 s). Meant for a checkout whose kernels have the counters (this
  one's).

It prints a line per root and writes all of them, with the card's name and
power limit, to ``chiprun_out/rdb_bwd_study.json`` (backward) or
``chiprun_out/rdb_bwd_study_<mode>.json``. It exits 1 without a CUDA device.
"""

import json
import os
import subprocess
import sys

SHAPES = ((16, 72, 72, 64), (48, 64, 64, 64), (8, 60, 60, 64), (16, 48, 48, 64), (16, 32, 32, 64))
FWD_SHAPES = ((1, 256, 256, 64), *SHAPES)
FLASH_SHAPES = ((1, 16384, 4, 16), (1, 11875, 4, 32))
GC = 32
MODES = ("backward", "forward", "flash", "probe")

COMMON = r"""
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

def host_ms(fn, iters=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host

def rdb_inputs(shape, gc):
    n, h, w, ch = shape
    g0 = torch.Generator().manual_seed(404)
    x = torch.randn(shape, generator=g0)
    ks = [torch.randn(3, 3, ch + k * gc, gc if k < 4 else ch, generator=g0) / (3 * (ch + k * gc) ** 0.5)
          for k in range(5)]
    bs = [torch.randn(gc if k < 4 else ch, generator=g0) * 0.1 for k in range(5)]
    return x.cuda(), [k.cuda() for k in ks], [b.cuda() for b in bs]

def qkv(shape):
    g0 = torch.Generator().manual_seed(406)
    return [torch.randn(shape, generator=g0).cuda().bfloat16() for _ in range(3)]

out = {}
shapes, gc = json.loads(sys.argv[2]), int(sys.argv[3])
"""

BACKWARD = COMMON + r"""
for shape in shapes:
    x, ks, bs = rdb_inputs(shape, gc)
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        xd = x.to(dt)
        packed = rdb.pack_rdb_weights(ks, bs, dt)
        with torch.no_grad():
            _, feat = rdb.rdb_forward_ref(xd, ks, bs, with_feat=True)
        cot = torch.randn(shape, generator=torch.Generator().manual_seed(405)).cuda().to(dt)
        args = (xd, feat, cot, packed, gc)
        out["x".join(map(str, shape[:3])) + "_" + name] = {
            "ms": graph_ms(lambda: rdb.rdb_backward(*args)), "host_ms": host_ms(lambda: rdb.rdb_backward(*args))}
print(json.dumps(out))
"""

FORWARD = COMMON + r"""
for shape in shapes:
    x, ks, bs = rdb_inputs(shape, gc)
    xb = x.bfloat16()
    packed = rdb.pack_rdb_weights(ks, bs, torch.bfloat16)
    with torch.inference_mode():
        fn = lambda: rdb.rdb_forward(xb, ks, bs, packed)
        out["x".join(map(str, shape[:3])) + "_bf16"] = {"ms": graph_ms(fn), "host_ms": host_ms(fn)}
print(json.dumps(out))
"""

FLASH = COMMON + r"""
import torch.nn.functional as F
from srganfd_tpu_torch.ops.cuda import attention
for shape in shapes:
    q, k, v = qkv(shape)
    with torch.inference_mode():
        fn = lambda: attention.flash_attention(q, k, v)
        sdpa = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        out["x".join(map(str, shape)) + "_bf16"] = {"ms": graph_ms(fn), "host_ms": host_ms(fn),
                                                     "sdpa_ms": graph_ms(sdpa)}
print(json.dumps(out))
"""

PROBE = COMMON + r"""
import ctypes
from srganfd_tpu_torch.ops.cuda import attention, build
flash_shapes = json.loads(sys.argv[4])
libs = {}
for mod, name in ((rdb, "rdb"), (attention, "flash_attention")):
    libs[name] = build.load_library(name, ("SRGANFD_PROBE",))
    mod.load_library = lambda n, _d=("SRGANFD_PROBE",): build.load_library(n, _d)  # the wrappers' next load
    mod._lib = None

def read(name):
    sums = (ctypes.c_ulonglong * 8)()
    rc = getattr(libs[name], name.split("_")[0] + "_probe_read")(sums)
    if rc:
        raise RuntimeError(f"{name} probe read failed ({rc})")
    return list(sums)

def per_tile(s, names, blocks=False):
    tiles = max(s[3], 1)
    out = {**{n: s[i] / tiles for i, n in enumerate(names)}, "tiles": s[3], "producer_wait": s[4] / tiles}
    if blocks:  # per block: its weights' copy, then the wait for the launch before
        out.update(weights=s[5] / max(s[7], 1), launch_wait=s[6] / max(s[7], 1), blocks=s[7])
    return out

with torch.inference_mode():
    for shape in shapes:
        x, ks, bs = rdb_inputs(shape, gc)
        xb = x.bfloat16()
        packed = rdb.pack_rdb_weights(ks, bs, torch.bfloat16)
        rdb.rdb_forward(xb, ks, bs, packed)
        torch.cuda.synchronize()
        read("rdb")
        for _ in range(5):
            rdb.rdb_forward(xb, ks, bs, packed)
        torch.cuda.synchronize()
        out["rdb_" + "x".join(map(str, shape[:3]))] = per_tile(read("rdb"), ("wait", "products", "epilogue"), True)
    for shape in flash_shapes:
        q, k, v = qkv(shape)
        attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        read("flash_attention")
        for _ in range(5):
            attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        sums = read("flash_attention")
        out["flash_" + "x".join(map(str, shape))] = {**per_tile(sums, ("wait", "s_products", "softmax")),
                                                      "pv_issue": sums[5] / max(sums[3], 1)}
    # the SM clock that the cycles above ran at: sampled while flash runs back to back for 2 s
    import subprocess
    q, k, v = qkv(flash_shapes[0])
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    time.sleep(1.0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(20):
            attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
    smi.terminate()
    mhz = sorted(float(l) for l in smi.communicate()[0].split() if l.replace(".", "").isdigit())
    out["sm_clock_mhz"] = {"median": mhz[len(mhz) // 2] if mhz else None, "samples": len(mhz)}
print(json.dumps(out))
"""


def main() -> None:
    args = sys.argv[1:]
    mode = "backward"
    if args[:1] == ["--mode"]:
        mode, args = args[1] if len(args) > 1 else "", args[2:]
    import torch

    if mode not in MODES or not torch.cuda.is_available() or not args:
        sys.exit(f"rdb_bwd_study.py [--mode {'|'.join(MODES)}] ROOT [ROOT ...] needs a CUDA device and a checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    worker, shapes = {"backward": (BACKWARD, SHAPES), "forward": (FORWARD, FWD_SHAPES),
                      "flash": (FLASH, FLASH_SHAPES), "probe": (PROBE, FWD_SHAPES)}[mode]
    runs = []
    for root in args:
        proc = subprocess.run([sys.executable, "-c", worker, os.path.abspath(root), json.dumps(shapes), str(GC),
                               json.dumps(FLASH_SHAPES)], capture_output=True, text=True, cwd=os.path.abspath(root))
        if proc.returncode:
            sys.exit(f"{root}: {proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root, "times" if mode != "probe" else "cycles": res})
        print(root, {k: {q: (round(v, 4) if isinstance(v, float) else v) for q, v in r.items()} for k, r in res.items()},
              flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "rdb_bwd_study.json" if mode == "backward" else f"rdb_bwd_study_{mode}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump({"card": smi, "mode": mode, "shapes": shapes, "flash_shapes": FLASH_SHAPES, "gc": GC,
                   "runs": runs}, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
