"""Weights carried between the JAX generator's Flax tree and the port's
reference-named state dict (``srganfd_tpu_torch/convert.py``)."""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from srganfd_tpu.models.blocks import stack_trunk_params
from srganfd_tpu_torch.convert import (
    flax_to_state_dict,
    load_generator_weights,
    state_dict_to_flax,
)
from srganfd_tpu_torch.models import create_model

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

from export_to_torch import export_rrdb_generator  # noqa: E402
from test_torch_generator import ARCHS, tiny_kwargs, tiny_params  # noqa: E402

def flax_params(arch, scan_blocks=False):
    """Tiny params; ``scan_blocks`` gives the ``ScanRRDB`` layout that
    ``create_model(..., scan_blocks=True)`` initialises (the tree of
    ``stack_trunk_params``, whose equivalence the JAX package's tests pin)."""
    params = tiny_params(arch)
    return stack_trunk_params(params, 2) if scan_blocks else params


def assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("scan_blocks", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_flax_torch_flax_round_trip_is_exact(arch, scan_blocks):
    params = flax_params(arch, scan_blocks)
    sd = flax_to_state_dict(params)
    # the state dict loads strictly into the port's module
    model = create_model(arch, **tiny_kwargs(arch))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    back = state_dict_to_flax(model.state_dict(), num_blocks=2, scan_blocks=scan_blocks)
    assert_trees_equal(back, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_matches_export_tool(arch):
    params = flax_params(arch)
    ours, tool = flax_to_state_dict(params), export_rrdb_generator(params)
    assert set(ours) == set(tool)
    for k in tool:
        np.testing.assert_array_equal(ours[k], tool[k], err_msg=k)


def test_load_generator_weights_formats(tmp_path):
    params = flax_params("bsrgan_x2")
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(params).items()}
    torch.save({"state_dict": sd}, tmp_path / "g.pth")
    torch.save(sd, tmp_path / "bare.pth")
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "g.npz", **flat)
    np.savez(tmp_path / "state.npz", **{f"g_params/{k}": v for k, v in flat.items()},
             **{f"ema_g_params/{k}": v + 1 for k, v in flat.items()})
    for name in ("g.pth", "bare.pth", "g.npz", "state.npz"):
        got = load_generator_weights(str(tmp_path / name))
        assert set(got) == set(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), (name, k)
    ema = load_generator_weights(str(tmp_path / "state.npz"), use_ema=True)
    assert torch.equal(ema["conv1.bias"], sd["conv1.bias"] + 1)
    with pytest.raises(ValueError, match="ema"):
        load_generator_weights(str(tmp_path / "g.pth"), use_ema=True)
    with pytest.raises(ValueError, match="tools/export_to_torch.py"):
        load_generator_weights(str(tmp_path))
