"""Model summary: parameter counts per top-level module (counterpart of
``srganfd_tpu/cli/summary.py``; the reference's A-ESRGAN trainer prints a
torchsummary table).

Rows are the port's top-level children (``conv1``, ``trunk``, ...), where
the JAX CLI lists Flax's auto-named submodules; the TOTAL counts the same
parameters. Buffers (the spectral-norm ``u`` vectors and the BatchNorm
running statistics), which the JAX CLI lists as "mutable collections", are
listed by kind. The model is built on the meta device: nothing is
allocated or initialised.

Usage:
    python -m srganfd_tpu_torch.cli.summary --arch bsrgan_x4 [--input-size 32] [--channels 64]
"""

from __future__ import annotations

import argparse

import torch

from srganfd_tpu_torch.models import create_model

__all__ = ["summarize", "main"]


def summarize(arch: str, input_size: int = 32, channels: int | None = None) -> dict:
    """``{"rows": [(child, n_params)], "total": n, "buffers": {kind: n}}``
    for ``arch`` (``channels`` overrides its width)."""
    kwargs = {"channels": channels} if channels else {}
    with torch.device("meta"):
        model = create_model(arch, **kwargs)
    rows = [(name, sum(p.numel() for p in child.parameters())) for name, child in model.named_children()]
    direct = sum(p.numel() for p in model.parameters(recurse=False))
    if direct:
        rows.append(("(own parameters)", direct))
    buffers: dict[str, int] = {}
    for name, b in model.named_buffers():
        kind = name.rsplit(".", 1)[-1]
        buffers[kind] = buffers.get(kind, 0) + b.numel()
    return {"rows": rows, "total": sum(n for _, n in rows), "buffers": buffers}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="parameter summary for an arch")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--input-size", type=int, default=32,
                    help="printed in the header, as in the JAX CLI; the counts do not depend on it")
    ap.add_argument("--channels", type=int, default=None)
    args = ap.parse_args(argv)
    s = summarize(args.arch, args.input_size, args.channels)
    width = max(len(name) for name, _ in s["rows"])
    print(f"{args.arch} @ {args.input_size}px input")
    for name, n in s["rows"]:
        print(f"  {name:<{width}}  {n:>12,}")
    total = s["total"]
    print(f"  {'TOTAL':<{width}}  {total:>12,}  ({total * 4 / 1e6:.1f} MB f32)")
    if s["buffers"]:
        print(f"  buffers: {s['buffers']}")


if __name__ == "__main__":
    main()
