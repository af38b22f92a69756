"""The f32 step check (``srganfd_tpu_torch/train/step_check.py``) on
synthetic state dicts of a small RRDB trunk between two convs. Its channel
rule holds G per tensor to 1e-5 outside the output channels that hold a
LeakyReLU slope flip and the biases outside the RDBs, and to 1e-3 inside
them: a fault outside a flipped channel fails, a flip-sized difference
inside one passes, a lost gradient fails anywhere. The limits chip_smoke.py
holds (G to 1e-3) pass the small fault and fail the lost gradient. The
flips and their channels are the sign changes of the recomputed
pre-activations."""

import numpy as np
import pytest
import torch
from torch import nn

from srganfd_tpu_torch.models import blocks
from srganfd_tpu_torch.train import step_check

CH, GC = 16, 8
RULE = step_check.CHANNEL_RULE


class _Trunk(nn.Module):
    """A first conv, an RRDB trunk and a last conv, named as the
    generators name them."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, CH, 3, padding=1)
        self.trunk = blocks.make_trunk(CH, GC, 2)
        self.conv2 = nn.Conv2d(CH, CH, 3, padding=1)


def _state(seed):
    """A trunk's G after one step: weights from init, every conv bias an
    Adam-sized update of ~1e-4 with both signs (the tensors whose relative
    change a flip moves most)."""
    torch.manual_seed(seed)
    g = {k: v.detach().clone() for k, v in _Trunk().state_dict().items()}
    rng = np.random.default_rng(seed)
    for k in g:
        if k.endswith(".bias"):
            g[k] = torch.from_numpy(rng.uniform(-1e-4, 1e-4, g[k].shape).astype(np.float32))
    return g


def _names():
    return [n for n, m in _Trunk().named_modules() if isinstance(m, blocks.ResidualDenseBlock)]


FLIPPED = {"trunk.1.rdb2.conv3": torch.tensor([5])}  # one flip, in channel 5 of that conv


def _readings(g_a, g_b, flipped=FLIPPED, outer=True):
    return {"lr_max_abs": 0.0, "loss_rel": 0.0, "slope_flips": 30,
            **step_check.g_agreement(g_a, g_b, flipped, outer=outer)}


def test_identical_states_pass():
    g = _state(0)
    r = _readings(g, g)
    assert r["g_outside"] == 0 and r["g_inside"] == 0 and not step_check.step_check_failures(r, RULE)
    # bias[5] and weight[5] of the flipped conv, and the outer convs' biases
    assert r["g_excluded_elements"] == 1 + 9 * (CH + 2 * GC) + 2 * CH


def test_a_fault_in_an_unflipped_channel_fails():
    """1e-4 of the tensor's largest element, in channel 4 of the flipped
    conv's bias: outside the flipped channel, over 1e-5."""
    g_b = _state(1)
    g_a = {k: v.clone() for k, v in g_b.items()}
    bias = "trunk.1.rdb2.conv3.bias"
    g_a[bias][4] += 1e-4 * g_b[bias].abs().max()
    r = _readings(g_a, g_b)
    assert r["g_outside_worst"] == bias and r["g_outside"] == pytest.approx(1e-4, rel=1e-3)
    assert step_check.step_check_failures(r, RULE) == [f"g_outside {r['g_outside']:.3g} > 1e-05"]
    assert r["g_outside_top5"][0] == (bias, r["g_outside"])


def test_a_flip_sized_difference_in_the_flipped_channel_passes():
    """5e-4, up to twice what one flip was seen to move a zero-started
    bias's update, confined to the flipped channel: held only to 1e-3."""
    g_b = _state(2)
    g_a = {k: v.clone() for k, v in g_b.items()}
    bias = "trunk.1.rdb2.conv3.bias"
    g_a[bias][5] += 5e-4 * g_b[bias].abs().max()
    g_a["trunk.1.rdb2.conv3.weight"][5] *= 1 + 2e-4
    r = _readings(g_a, g_b)
    assert r["g_outside"] == 0 and r["g_inside_worst"] == bias
    assert r["g_inside"] == pytest.approx(5e-4, rel=1e-3)
    assert not step_check.step_check_failures(r, RULE)
    # the same difference in a conv without a flip fails
    assert step_check.step_check_failures(_readings(g_a, g_b, flipped={}), RULE)


@pytest.mark.parametrize("bias", ["trunk.0.rdb1.conv1.bias", "trunk.1.rdb2.conv3.bias"])
def test_a_lost_gradient_fails(bias):
    """A bias left at its init (zero) by a lost gradient: its whole update
    is missing, relative 1, over both limits, flipped channel or not."""
    g_b = _state(3)
    g_a = {k: v.clone() for k, v in g_b.items()}
    g_a[bias] = torch.zeros_like(g_b[bias])
    r = _readings(g_a, g_b)
    assert max(r["g_outside"], r["g_inside"]) == pytest.approx(1.0)
    assert step_check.step_check_failures(r, RULE)


def test_the_outer_biases_are_held_to_the_inside_limit():
    """Every trunk flip reaches the zero-started biases outside the RDBs:
    there 5e-4 passes; with ``outer=False`` it fails, and a lost gradient
    there fails either way."""
    g_b = _state(6)
    g_a = {k: v.clone() for k, v in g_b.items()}
    g_a["conv1.bias"][3] += 5e-4 * g_b["conv1.bias"].abs().max()
    r = _readings(g_a, g_b)
    assert r["g_outside"] == 0 and r["g_inside_worst"] == "conv1.bias"
    assert not step_check.step_check_failures(r, RULE)
    assert step_check.step_check_failures(_readings(g_a, g_b, outer=False), RULE)
    g_a["conv2.bias"] = torch.zeros_like(g_b["conv2.bias"])
    assert step_check.step_check_failures(_readings(g_a, g_b), RULE)
    # the outer convs' weights stay held to 1e-5
    g_a = {k: v.clone() for k, v in g_b.items()}
    g_a["conv2.weight"][0, 0, 0, 0] += 1e-4 * g_b["conv2.weight"].abs().max()
    assert _readings(g_a, g_b)["g_outside_worst"] == "conv2.weight"


def test_the_held_limits_let_a_small_fault_through():
    """The limits chip_smoke.py holds take G to 1e-3 everywhere: a 1e-4
    fault in an unflipped channel passes them (the channel rule fails it),
    a lost gradient does not."""
    assert step_check.LIMITS == {**RULE, "g_outside": 1e-3}
    g_b = _state(7)
    g_a = {k: v.clone() for k, v in g_b.items()}
    bias = "trunk.1.rdb2.conv3.bias"
    g_a[bias][4] += 1e-4 * g_b[bias].abs().max()
    assert not step_check.step_check_failures(_readings(g_a, g_b), step_check.LIMITS)
    assert step_check.step_check_failures(_readings(g_a, g_b), RULE)
    g_a[bias] = torch.zeros_like(g_b[bias])
    assert step_check.step_check_failures(_readings(g_a, g_b), step_check.LIMITS)


def test_flips_over_the_limit_fail():
    g = _state(4)
    r = {**_readings(g, g), "slope_flips": 251}
    assert step_check.step_check_failures(r, RULE) == ["slope_flips 251 > 250"]
    assert step_check.step_check_failures(r, step_check.LIMITS) == ["slope_flips 251 > 250"]


def test_slope_flips_name_the_flipped_channels():
    """Two runs' RDB inputs that differ by a little: the flips are the sign
    changes of the four recomputed pre-activations, and their channels
    come back keyed by the RDB's convs."""
    rng = np.random.default_rng(5)
    model = _Trunk()
    rdbs = [m for m in model.modules() if isinstance(m, blocks.ResidualDenseBlock)]
    inputs_a, inputs_b, want_counts, want = [], [], [], {}
    for name, rdb in zip(_names(), rdbs):
        ks, bs = (list(t) for t in rdb.kernels_biases())
        x = torch.from_numpy(rng.normal(size=(2, 6, 7, CH)).astype(np.float32))
        x2 = x + torch.from_numpy(rng.normal(scale=1e-2, size=x.shape).astype(np.float32))
        inputs_a.append((x, ks, bs))
        inputs_b.append((x2, ks, bs))
        zs_a = step_check.rdb_preactivations(x, ks, bs)
        zs_b = step_check.rdb_preactivations(x2, ks, bs)
        count = 0
        for k, (za, zb) in enumerate(zip(zs_a, zs_b)):
            flip = (za > 0) != (zb > 0)
            count += int(flip.sum())
            chans = sorted({int(c) for c in torch.nonzero(flip)[:, 1]})
            if chans:
                want[f"{name}.conv{k + 1}"] = chans
        want_counts.append(count)
    with torch.no_grad():
        counts, channels = step_check.slope_flips(inputs_a, inputs_b)
    assert counts == want_counts and sum(counts) > 0
    got = step_check.flipped_channels(_names(), channels)
    assert {k: v.tolist() for k, v in got.items()} == want
    with pytest.raises(ValueError, match="RDB names"):
        step_check.flipped_channels(_names()[:1], channels)
