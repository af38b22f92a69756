"""Generator-only trainer of the port (counterpart of
``srganfd_tpu/train/loop.py`` ``Trainer`` for configs without a
discriminator: the L1 pretrain of ``ESRGAN/train_rrdbnet.py:213-286`` and
``BSRGAN/train_bsrnet.py``).

One step: one generator forward, the weighted L1 pixel loss, its backward,
an Adam update at the lr that ``multistep_lr`` gives for the step count,
then the EMA. Adam is ``torch.optim.Adam(lr, betas, eps=model_eps,
weight_decay=0)``, which computes what the JAX package's
``optax.adamw(..., weight_decay=0)`` computes. Parameters and Adam state
are f32; ``compute_dtype="bfloat16"`` runs the generator in bf16 as Flax's
``dtype`` does (each conv casts its f32 parameters at call time).

Each RDB of the forward is ``ops/cuda/rdb.py`` ``rdb_apply``: the
hand-written kernel on a CUDA tensor, its backward through the plain
version, recomputed, as the JAX ``rdb_apply`` does.

Not ported yet, each rejected with its ROADMAP.md item: discriminators and
the content/adversarial losses, ``grad_accum_steps``,
``skip_nonfinite_updates``, ``grad_clip_norm``, weight decay (A4), the pipe
mesh (A11), and the K-step and fused dispatch modes (A4).
"""

from __future__ import annotations

import torch

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.train.schedule import multistep_lr
from srganfd_tpu_torch.train.state import TrainState, ema_update

__all__ = ["Trainer", "COMPUTE_DTYPES"]

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _weighted(weights: tuple[float, ...], losses: torch.Tensor) -> torch.Tensor:
    """torch.sum(torch.mul(w, losses)) with broadcast semantics
    (``BSRGAN/train_bsrgan.py:450-453``): scalar weight lists scale the
    summed loss; per-node lists dot with per-node losses."""
    w = torch.tensor(weights, dtype=torch.float32, device=losses.device)
    losses = losses.reshape(-1)
    if w.shape[0] == 1 or losses.shape[0] == 1 or w.shape[0] == losses.shape[0]:
        return torch.sum(w * losses)
    raise ValueError(f"weight list {tuple(w.shape)} incompatible with losses {tuple(losses.shape)}")


def _reject_unported(cfg: ExperimentConfig) -> None:
    unported = {
        "a discriminator (d_arch)": (cfg.d_arch is not None, "A4"),
        "content_weight": (bool(cfg.content_weight), "A4"),
        "adversarial_weight": (bool(cfg.adversarial_weight), "A4"),
        "grad_accum_steps > 1": (cfg.grad_accum_steps > 1, "A4"),
        "skip_nonfinite_updates": (cfg.skip_nonfinite_updates, "A4"),
        "grad_clip_norm": (cfg.grad_clip_norm > 0, "A4"),
        "model_weight_decay": (cfg.model_weight_decay != 0, "A4"),
        "pipeline_microbatches": (cfg.pipeline_microbatches > 0, "A11"),
    }
    for what, (used, item) in unported.items():
        if used:
            raise NotImplementedError(
                f"{what} is not ported to srganfd_tpu_torch yet: see ROADMAP.md {item}"
            )
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}"
        )


class Trainer:
    """Builds the generator and its optimizer from an ExperimentConfig and
    exposes ``train_step`` and ``eval_sr``."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        steps_per_epoch: int = 1000,
        device: torch.device | str = "cpu",
    ) -> None:
        _reject_unported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        milestones = tuple(m * steps_per_epoch for m in cfg.milestones_epochs)
        self.schedule = multistep_lr(cfg.model_lr, milestones, cfg.lr_scheduler_gamma)

    def init_state(self, init: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh state: G from the seeded kaiming x0.1 init (``cfg.seed``),
        or from ``init`` (a reference-named state dict) when given; a new
        Adam; EMA a copy of G."""
        cfg = self.cfg
        model = create_model(
            cfg.g_arch, dtype=self.dtype, generator=torch.Generator().manual_seed(cfg.seed),
            **cfg.g_kwargs,
        )
        if init is not None:
            model.load_state_dict(init)
        model.to(self.device).train()
        opt = torch.optim.Adam(
            model.parameters(), lr=self.schedule(0), betas=tuple(cfg.model_betas),
            eps=cfg.model_eps, weight_decay=0.0,
        )
        ema = {k: v.detach().clone() for k, v in model.named_parameters()}
        return TrainState(step=0, g_model=model, g_opt=opt, ema_g=ema)

    def train_step(
        self, state: TrainState, gt: torch.Tensor, lr_img: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        """One update of ``state`` in place; returns the step's losses as
        0-d tensors on the device (reading one waits for the step)."""
        cfg = self.cfg
        for group in state.g_opt.param_groups:  # optax's count: updates before this one
            group["lr"] = self.schedule(state.step)
        sr = state.g_model(lr_img)
        pixel = _weighted(cfg.pixel_weight, torch.mean(torch.abs(sr - gt)))
        state.g_opt.zero_grad(set_to_none=True)
        pixel.backward()
        state.g_opt.step()
        ema_update(
            state.ema_g, dict(state.g_model.named_parameters()), cfg.model_ema_decay,
            reference_semantics=cfg.ema_reference_semantics, step=state.step,
        )
        state.step += 1
        loss = pixel.detach()
        return {"pixel_loss": loss, "g_loss": loss}

    @torch.inference_mode()
    def eval_sr(self, state: TrainState, lr_img: torch.Tensor) -> torch.Tensor:
        """SR of ``lr_img`` by G (the reference validates the raw generator)."""
        return state.g_model(lr_img)
