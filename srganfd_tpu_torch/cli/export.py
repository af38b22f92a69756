"""Export a generator for serving (counterpart of ``srganfd_tpu/cli/export.py``).

Writes two files:

- ``<out>.pt2``: the generator's forward as a ``torch.export`` program
  (``torch.export.save``) for the input ``(batch, input-size, input-size,
  3)`` f32 NHWC, the port generator's layout. Each RDB is one node, the
  custom op ``srganfd::rdb_forward`` (``ops/cuda/rdb.py``), which launches
  the hand-written kernel on the card, on weights packed once at export and
  held as the program's constants (the RDBs' raw weights are not in the
  program), and runs the plain version on the CPU, on the flattened HWIO
  kernels; so loading the program needs ``srganfd_tpu_torch`` imported (it
  registers the op): ``import srganfd_tpu_torch.ops.cuda.rdb`` before
  ``torch.export.load(path).module()``.
- ``<out>.params.npz``: the weights as the JAX export writes them, the Flax
  tree's ``/``-joined paths (``convert.state_dict_to_flax``).

The weights are the EMA generator of a ``cli.train`` checkpoint, as the JAX
CLI takes ``ema_g_params``; without ``--weights`` the seeded init is
exported. The program is traced in eval mode under ``torch.no_grad`` on
``--device-type`` (default ``cuda``).

Usage:
    python -m srganfd_tpu_torch.cli.export --model-arch bsrgan_x2 \\
        --weights results/BSRGAN_x2/ckpt_best.pth --input-size 128 --batch 1 --out export/bsrgan_x2
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from srganfd_tpu_torch.cli.infer import choice_device
from srganfd_tpu_torch.convert import flatten_flax, load_generator_weights, state_dict_to_flax
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.models.blocks import ResidualDenseBlock

__all__ = ["export_generator", "main"]


def _num_blocks(sd: dict) -> int:
    trunk = "body." if "conv_first.weight" in sd else "trunk."
    return len({k.split(".")[1] for k in sd if k.startswith(trunk)})


def export_generator(arch: str, out: str, weights: str = "", input_size: int = 128, batch: int = 1,
                     device: torch.device | str = "cuda", seed: int = 0, model_kwargs: dict | None = None) -> dict:
    """Export ``arch`` (built with ``model_kwargs``) as ``<out>.pt2`` and
    ``<out>.params.npz``; returns ``{"program": path, "params": path,
    "arrays": count}``."""
    device = torch.device(device)
    model = create_model(arch, generator=torch.Generator().manual_seed(seed), **(model_kwargs or {}))
    if weights:
        model.load_state_dict(load_generator_weights(weights, use_ema=True))
    else:
        print("! no --weights: exporting randomly initialized generator")
    model = model.to(device).eval().requires_grad_(False)
    sd = model.state_dict()  # before the RDBs hand their weights to the packed constants
    x = torch.zeros((batch, input_size, input_size, 3), dtype=torch.float32, device=device)
    for m in model.modules():
        if isinstance(m, ResidualDenseBlock):
            m.pack_for_export(x.dtype)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    os.makedirs(os.path.dirname(os.path.abspath(out)) or ".", exist_ok=True)
    torch.export.save(program, out + ".pt2")
    flat = flatten_flax(state_dict_to_flax(sd, _num_blocks(sd)))
    np.savez(out + ".params.npz", **flat)
    return {"program": out + ".pt2", "params": out + ".params.npz", "arrays": len(flat)}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="export a generator as a torch.export program (.pt2; loading it "
                                 "needs srganfd_tpu_torch imported, which registers its RDB op) and a Flax-path "
                                 ".params.npz")
    ap.add_argument("--model-arch", dest="arch", required=True)
    ap.add_argument("--weights", default="", help="a checkpoint of cli.train (its EMA generator is exported)")
    ap.add_argument("--input-size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device-type", dest="device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = choice_device(args.device)
    res = export_generator(args.arch, args.out, args.weights, args.input_size, args.batch, device)
    shape = (args.batch, args.input_size, args.input_size, 3)
    print(f"exported {args.arch} for input {shape} ->\n"
          f"  {res['program']} ({os.path.getsize(res['program'])} bytes)\n"
          f"  {res['params']} ({res['arrays']} arrays)")


if __name__ == "__main__":
    main()
