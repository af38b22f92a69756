"""The dispatch modes' CUDA graphs on the card (``train/graphs.py``): a
graph's replays against the same dispatches run eagerly, bit for bit. The
file imports no JAX, so the card's test command runs it; here the case
skips. Run it there with ``python -m pytest --noconftest -m cuda
tests/test_torch_dispatch_cuda.py``."""

import numpy as np
import pytest
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.ops import degrade
from srganfd_tpu_torch.train.loop import Trainer

BSRGAN = dict(compute_dtype="float32", epochs=2, g_kwargs={"channels": 16, "growth_channels": 8, "num_rrdb": 1},
              d_kwargs={"channels": 8}, content_weight=(), gt_image_size=16, skip_nonfinite_updates=True)
RAW = 48


def _steps(seed: int, n: int):
    rng = np.random.default_rng(seed)
    raws = rng.integers(0, 256, (n, 2, RAW, RAW, 3)).astype(np.uint8)
    out = []
    for raw in raws:
        plan = degrade.plan_bsrgan_batch(rng, 2, 2, per_sample_order=True)
        lim = degrade.bsrgan_lr_size(RAW, plan) - 8
        out.append((raw, plan, rng.integers(0, lim + 1, 2), rng.integers(0, lim + 1, 2)))
    return out


@pytest.mark.cuda
def test_graph_replays_equal_eager_dispatches_on_the_card():
    """Six fused ``bsrgan`` steps (16 channels: the RDB kernel takes
    multiples of 8) as three K = 2 dispatches: with graphs, the first eager
    and then one capture and two replays; against all three run eagerly.
    G, EMA-G, D and both Adams bit for bit, the metrics too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for graphs in (True, False):
            tr = Trainer(configs.get_config("bsrgan", **BSRGAN), steps_per_epoch=4, device="cuda")
            tr.cuda_graphs = graphs
            st = tr.init_state()
            steps = _steps(7, 6)
            metrics = [tr.bsrgan_fused_train_multi_step(st, *map(list, zip(*steps[i:i + 2])), 16)
                       for i in (0, 2, 4)]
            if graphs:
                stats = tr.graph_stats()
                assert (stats["captured"], stats["eager_dispatches"], stats["replays"]) == (1, 1, 2)
            tensors = {f"g.{k}": v for k, v in st.g_model.state_dict().items()}
            tensors.update({f"ema.{k}": v for k, v in st.ema_g.items()})
            tensors.update({f"d.{k}": v for k, v in st.d_model.state_dict().items()})
            for tag, opt in (("g", st.g_opt), ("d", st.d_opt)):
                for i, s in enumerate(opt.state.values()):
                    tensors.update({f"{tag}_opt.{i}.{k}": v for k, v in s.items()})
            runs.append((tensors, metrics))
    finally:
        torch.use_deterministic_algorithms(False)
    (ta, ma), (tb, mb) = runs
    assert set(ta) == set(tb)
    assert [k for k in ta if not torch.equal(ta[k], tb[k])] == []
    assert all(torch.equal(a[k], b[k]) for a, b in zip(ma, mb) for k in a)
