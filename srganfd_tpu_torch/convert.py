"""Carry generator weights between the JAX package's Flax tree and the
port's reference-named state dict.

The Flax tree of an RRDB generator (``RRDBNet``/``BSRGAN``) holds
``Conv_0`` (conv1), the trunk as ``RRDB_{i}/ResidualDenseBlock_{j}/
conv{k}_{kernel,bias}`` (or, with ``scan_blocks=True``, one
``ScanRRDB/RRDB_0`` subtree whose leaves carry a leading block axis),
``Conv_1`` (conv2), then the upsampling convs, conv3 and conv4 in call
order, each as ``Conv_n/Conv_0/{kernel,bias}`` with HWIO kernels. The
state dict uses the reference names ``conv1``, ``trunk.{i}.rdb{j}.conv{k}``,
``conv2``, ``upsampling{n}.0``, ``conv3.0``, ``conv4`` with OIHW weights,
as ``tools/export_to_torch.py`` writes them (the mapping is this module's
own copy).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "state_dict_to_flax", "load_generator_weights"]


def _np(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _hwio_to_oihw(w: Any) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (3, 2, 0, 1)))


def _oihw_to_hwio(w: Any) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _unstack_trunk(params: dict) -> dict:
    """Scanned trunk (``ScanRRDB``) -> unrolled ``RRDB_{i}`` entries."""
    key = next((k for k in params if k.startswith("ScanRRDB")), None)
    if key is None:
        return dict(params)
    inner = next(iter(params[key].values()))

    def take(tree: dict, i: int) -> dict:
        return {k: take(v, i) if isinstance(v, dict) else _np(v)[i] for k, v in tree.items()}

    def depth(tree: Any) -> int:
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return int(_np(tree).shape[0])

    out = {k: v for k, v in params.items() if k != key}
    for i in range(depth(inner)):
        out[f"RRDB_{i}"] = take(inner, i)
    return out


def flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """Flax generator params (unrolled or scanned trunk, nested dicts of
    arrays) -> reference-named numpy state dict."""
    params = _unstack_trunk(params)
    num_blocks = sum(1 for k in params if k.startswith("RRDB_"))
    if num_blocks == 0:
        raise ValueError("no RRDB_* / ScanRRDB trunk in the param tree")
    sd: dict[str, np.ndarray] = {}

    def put_conv(flax_name: str, prefix: str) -> None:
        inner = params[flax_name]["Conv_0"]
        sd[f"{prefix}.weight"] = _hwio_to_oihw(inner["kernel"])
        sd[f"{prefix}.bias"] = _np(inner["bias"])

    put_conv("Conv_0", "conv1")
    for i in range(num_blocks):
        for j in range(3):
            rdb = params[f"RRDB_{i}"][f"ResidualDenseBlock_{j}"]
            for k in range(5):
                prefix = f"trunk.{i}.rdb{j + 1}.conv{k + 1}"
                sd[f"{prefix}.weight"] = _hwio_to_oihw(rdb[f"conv{k}_kernel"])
                sd[f"{prefix}.bias"] = _np(rdb[f"conv{k}_bias"])
    put_conv("Conv_1", "conv2")
    rest = sorted(
        (k for k in params if k.startswith("Conv_") and k not in ("Conv_0", "Conv_1")),
        key=lambda k: int(k.split("_")[1]),
    )
    if len(rest) < 2:
        raise ValueError(f"expected >= 2 tail convs, found {rest}")
    for u, name in enumerate(rest[:-2]):
        put_conv(name, f"upsampling{u + 1}.0")
    put_conv(rest[-2], "conv3.0")
    put_conv(rest[-1], "conv4")
    return sd


def state_dict_to_flax(sd: dict[str, Any], num_blocks: int, scan_blocks: bool = False) -> dict:
    """Inverse of :func:`flax_to_state_dict`: the Flax param tree with an
    unrolled trunk, or the ``ScanRRDB`` layout with ``scan_blocks=True``."""

    def conv(prefix: str) -> dict:
        return {"Conv_0": {"kernel": _oihw_to_hwio(sd[f"{prefix}.weight"]),
                           "bias": _np(sd[f"{prefix}.bias"])}}

    params: dict[str, Any] = {"Conv_0": conv("conv1"), "Conv_1": conv("conv2")}
    blocks = []
    for i in range(num_blocks):
        block = {}
        for j in range(3):
            rdb = {}
            for k in range(5):
                prefix = f"trunk.{i}.rdb{j + 1}.conv{k + 1}"
                rdb[f"conv{k}_kernel"] = _oihw_to_hwio(sd[f"{prefix}.weight"])
                rdb[f"conv{k}_bias"] = _np(sd[f"{prefix}.bias"])
            block[f"ResidualDenseBlock_{j}"] = rdb
        blocks.append(block)
    if scan_blocks:
        params["ScanRRDB"] = {"RRDB_0": {
            rdb: {leaf: np.stack([b[rdb][leaf] for b in blocks]) for leaf in blocks[0][rdb]}
            for rdb in blocks[0]
        }}
    else:
        params.update({f"RRDB_{i}": b for i, b in enumerate(blocks)})
    n_up = sum(1 for k in sd if k.startswith("upsampling") and k.endswith(".0.weight"))
    tail = [f"upsampling{u + 1}.0" for u in range(n_up)] + ["conv3.0", "conv4"]
    for n, prefix in enumerate(tail, start=2):
        params[f"Conv_{n}"] = conv(prefix)
    return params


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_generator_weights(path: str, use_ema: bool = False) -> dict[str, torch.Tensor]:
    """Reference-named generator state dict from

    - a ``.pth``/``.pt``: ``{"state_dict": ...}`` as ``tools/export_to_torch.py``
      writes it, or a bare state dict;
    - a ``.npz`` of the Flax tree with '/'-joined key paths, either the
      generator's params or a state holding ``g_params``/``ema_g_params``.

    ``use_ema`` picks ``ema_g_params`` where the file holds both; a file
    that holds one set of weights cannot honour it and raises.
    """
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint?): reading Orbax needs "
            "JAX. Convert it with `python tools/export_to_torch.py --arch <arch> "
            "--ckpt <dir> --key g_params|ema_g_params --out weights.pth`."
        )
    if path.endswith(".npz"):
        with np.load(path) as f:
            tree = _unflatten({k: f[k] for k in f.files})
        if "g_params" in tree:
            tree = tree["ema_g_params" if use_ema else "g_params"]
        elif use_ema:
            raise ValueError(f"--use-ema: {path} holds no ema_g_params")
        return {k: torch.from_numpy(v) for k, v in flax_to_state_dict(tree).items()}
    if use_ema:
        raise ValueError(
            f"--use-ema: {path} holds one set of weights; export the EMA one with "
            "`tools/export_to_torch.py --key ema_g_params`"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload.get("state_dict", payload)
