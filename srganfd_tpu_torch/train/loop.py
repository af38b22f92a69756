"""Trainer of the port (counterpart of ``srganfd_tpu/train/loop.py``
``Trainer``).

Generator-only configs (the L1 pretrains of ``ESRGAN/train_rrdbnet.py:213-286``,
``BSRGAN/train_bsrnet.py`` and ``Real_ESRGAN/train_realesrnet.py``): one
generator forward, the weighted L1 pixel loss, its backward, an Adam update
at the lr that ``multistep_lr`` gives for the step count, then the EMA.

GAN configs with the D step first (BSRGAN, ``BSRGAN/train_bsrgan.py:395-471``;
JAX ``make_train_step`` with ``g_step_first=False``):

1. one generator forward, whose graph both updates share;
2. the D update on the detached SR: BCE(D(gt), 1) + BCE(D(sr), 0), two
   train-mode forwards that each advance the spectral-norm ``u`` and the
   BatchNorm running statistics (gt first), or with ``fuse_d_forwards`` one
   forward on ``cat([gt, sr])`` and one power iteration, unless D has
   BatchNorm (fusing would pool the real and fake batch statistics); Adam
   on D at ``discriminator_lr`` under the same schedule;
3. the G update against the new D: pixel + content (VGG19) + adversarial
   (BCE(D(sr), 1), D with ``update_stats=False``: it normalises with the SR
   batch's statistics but writes neither ``u`` nor running statistics, and
   no gradient reaches D), each through ``_weighted``; Adam on G, then EMA.

A D may return a tuple, as the JAX modules do: the attention U-Net
``(logit map, attention maps)``, the multi-scale ensemble ``(per-scale
logit maps, attention maps)``. The losses take its first element; over
per-scale maps the BCEs are summed and the reported probabilities are
scale 0's (the JAX step's ``_first``, ``_bce_scales``, ``_mean_sigmoid``).

GAN configs with the G step first (Real-ESRGAN,
``Real_ESRGAN/train_realesrgan.py:407-470``, and ESRGAN,
``ESRGAN/train_esrgan.py:362-425``; ``g_step_first=True``): the G update
against the old D, then the D update on the same, detached SR, then EMA.

With ``relativistic_gan`` (ESRGAN) the adversarial terms are the
relativistic average ones: the D update's ``relativistic_d_loss(D(gt),
D(sr))`` from its two ``update_stats`` forwards, differentiated through
both means (only SR is detached, as the JAX step differentiates it), and
the G term's ``relativistic_g_loss(D(gt), D(sr))`` with D(gt) a constant
(run under ``no_grad``, as the JAX step's ``stop_gradient``) and neither
forward writing D's state. The D is always run in training mode, as the
JAX step's ``_d_apply`` runs it (``train=True``): BatchNorm normalises with
the batch's statistics.

A step takes an optional ``gt_pixel``: the pixel and content terms target
it (Real-ESRGAN's USM-sharpened GT) while D's real input stays ``gt``;
without it both are ``gt``.

Adam is ``torch.optim.Adam(lr, betas, eps=model_eps, weight_decay=0)``,
which computes what the JAX package's ``optax.adamw(..., weight_decay=0)``
computes. Parameters and Adam states are f32; ``compute_dtype="bfloat16"``
runs G, D and the VGG in bf16 as Flax's ``dtype`` does (each conv casts
its f32 parameters at call time); the losses are f32.

Each RDB of the generator is ``ops/cuda/rdb.py`` ``rdb_apply``: the
hand-written kernel on a CUDA tensor, its backward through the plain
version, recomputed, as the JAX ``rdb_apply`` does.

Not ported yet, each rejected with its ROADMAP.md item: ``grad_accum_steps``, ``skip_nonfinite_updates``, ``grad_clip_norm``,
weight decay (A4), the pipe mesh (A11), and the K-step and fused dispatch
modes (A4).
"""

from __future__ import annotations

import torch

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.losses.content import ContentLoss
from srganfd_tpu_torch.losses.gan import bce_with_logits, relativistic_d_loss, relativistic_g_loss
from srganfd_tpu_torch.models import check_ported, create_model
from srganfd_tpu_torch.models.blocks import BatchNorm
from srganfd_tpu_torch.train.schedule import multistep_lr
from srganfd_tpu_torch.train.state import TrainState, ema_update

__all__ = ["Trainer", "COMPUTE_DTYPES"]

# float64, as in the JAX Trainer, exists for lockstep parity tests on the
# CPU (it keeps cross-framework roundoff below what Adam's normalisation
# amplifies); the kernels take f32 and bf16, and raise on f64
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def _weighted(weights: tuple[float, ...], losses: torch.Tensor) -> torch.Tensor:
    """torch.sum(torch.mul(w, losses)) with broadcast semantics
    (``BSRGAN/train_bsrgan.py:450-453``): scalar weight lists scale the
    summed loss; per-node lists dot with per-node losses."""
    w = torch.tensor(weights, dtype=torch.float32, device=losses.device)
    losses = losses.reshape(-1)
    if w.shape[0] == 1 or losses.shape[0] == 1 or w.shape[0] == losses.shape[0]:
        return torch.sum(w * losses)
    raise ValueError(f"weight list {tuple(w.shape)} incompatible with losses {tuple(losses.shape)}")


Logits = torch.Tensor | tuple[torch.Tensor, ...]


def _first(out: Logits | tuple) -> Logits:
    """The logit map(s) of a D's output: a D that exposes attention maps
    returns a tuple whose first element they are (for the multi-scale
    ensemble itself a tuple of per-scale maps)."""
    return out[0] if isinstance(out, tuple) else out


def _bce_scales(logits: Logits, target: float) -> torch.Tensor:
    """BCE against a constant label over one logit map, or summed over a
    tuple of per-scale maps (the A-ESRGAN paper's ensemble loss)."""
    maps = logits if isinstance(logits, tuple) else (logits,)
    return sum(bce_with_logits(o, torch.full_like(o, target)) for o in maps)


def _mean_sigmoid(logits: Logits) -> torch.Tensor:
    """D's mean probability, over scale 0's map for an ensemble."""
    return torch.sigmoid(_first(logits).detach()).mean()


def _d_train_mode(d: torch.nn.Module, x: torch.Tensor, update_stats: bool) -> Logits:
    """D's logit map(s) in training mode, as the JAX step's ``_d_apply``
    (``train=True``) computes them: every D's ``train`` defaults to eval
    mode, as the JAX modules' does, so it is set here."""
    return _first(d(x, update_stats=update_stats, train=True))


def _reject_unported(cfg: ExperimentConfig) -> None:
    unported = {
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
    if cfg.d_arch is not None:
        check_ported(cfg.d_arch)
        if not cfg.is_gan:
            raise ValueError(
                f"d_arch={cfg.d_arch!r} without an adversarial_weight: no step would train the discriminator"
            )
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}"
        )


def _adam(model: torch.nn.Module, lr: float, cfg: ExperimentConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=tuple(cfg.model_betas),
                            eps=cfg.model_eps, weight_decay=0.0)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


class Trainer:
    """Builds the models, the losses and the optimizers from an
    ExperimentConfig and exposes ``train_step`` and ``eval_sr``."""

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
        self.d_schedule = multistep_lr(cfg.discriminator_lr or cfg.model_lr, milestones,
                                       cfg.lr_scheduler_gamma)
        self.has_d = cfg.is_gan
        self.content_loss = None
        if cfg.content_weight:
            self.content_loss = ContentLoss(
                nodes=cfg.feature_nodes, weights=cfg.content_weight,
                normalize_mean=cfg.feature_normalize_mean, normalize_std=cfg.feature_normalize_std,
                detach_bug=cfg.content_detach_bug, dtype=self.dtype,
            ).to(self.device)
            if not self.content_loss.pretrained:
                print("! VGG19 weights unavailable: the content loss runs on the seeded surrogate")

    def init_state(
        self,
        init: dict[str, torch.Tensor] | None = None,
        d_init: dict[str, torch.Tensor] | None = None,
    ) -> TrainState:
        """A fresh state: G, then D, from one generator seeded ``cfg.seed``
        (G: kaiming x0.1; D: lecun-normal plain convs, he-uniform SN convs,
        normal ``u``), or from ``init`` / ``d_init`` (reference-named state
        dicts, D's with its ``u`` buffers) when given; new Adams; EMA a copy
        of G."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed)
        model = create_model(cfg.g_arch, dtype=self.dtype, generator=gen, **cfg.g_kwargs)
        if init is not None:
            model.load_state_dict(init)
        model.to(self.device).train()
        ema = {k: v.detach().clone() for k, v in model.named_parameters()}
        state = TrainState(step=0, g_model=model, g_opt=_adam(model, self.schedule(0), cfg), ema_g=ema)
        if self.has_d:
            d = create_model(cfg.d_arch, dtype=self.dtype, generator=gen, **cfg.d_kwargs)
            if d_init is not None:
                d.load_state_dict(d_init)
            d.to(self.device).train()
            state.d_model, state.d_opt = d, _adam(d, self.d_schedule(0), cfg)
        return state

    def train_step(
        self,
        state: TrainState,
        gt: torch.Tensor,
        lr_img: torch.Tensor,
        gt_pixel: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        """One update of ``state`` in place; returns the step's losses (and,
        for a GAN, the D's loss and mean probabilities) as 0-d tensors on
        the device (reading one waits for the step). The pixel and content
        terms target ``gt_pixel`` when given, D's real input is ``gt``."""
        target = gt if gt_pixel is None else gt_pixel
        _set_lr(state.g_opt, self.schedule(state.step))  # optax's count: updates before this one
        sr = state.g_model(lr_img)
        metrics = {}
        if self.has_d and not self.cfg.g_step_first:
            metrics = self._d_update(state, gt, sr.detach())
        parts = self._g_losses(state, sr, target)
        state.g_opt.zero_grad(set_to_none=True)
        # D and the VGG are constants of the G update: no gradient reaches them
        parts["g_loss"].backward(inputs=list(state.g_model.parameters()))
        state.g_opt.step()
        if self.has_d and self.cfg.g_step_first:
            # the same SR, from G before its update, against the old D's
            # update, as the JAX step's d_update(state, gt, sr) takes it
            metrics = self._d_update(state, gt, sr.detach())
        ema_update(
            state.ema_g, dict(state.g_model.named_parameters()), self.cfg.model_ema_decay,
            reference_semantics=self.cfg.ema_reference_semantics, step=state.step,
        )
        state.step += 1
        metrics.update({k: v.detach() for k, v in parts.items()})
        return metrics

    def _d_update(self, state: TrainState, gt: torch.Tensor, sr: torch.Tensor) -> dict[str, torch.Tensor]:
        """BCE(D(gt), 1) + BCE(D(sr), 0), or with ``relativistic_gan`` the
        relativistic average loss of the same two forwards, with ``u`` and
        the running statistics advanced by each train forward, then Adam on
        D."""
        d = state.d_model
        _set_lr(state.d_opt, self.d_schedule(state.step))  # one D update per step
        # a BatchNorm D keeps the two forwards: one would pool the batches'
        # statistics (the Ds without BatchNorm return one logit map)
        if self.cfg.fuse_d_forwards and not any(isinstance(m, BatchNorm) for m in d.modules()):
            both = _d_train_mode(d, torch.cat([gt, sr]), update_stats=True)
            gt_out, sr_out = both[: gt.shape[0]], both[gt.shape[0]:]
        else:
            gt_out = _d_train_mode(d, gt, update_stats=True)
            sr_out = _d_train_mode(d, sr, update_stats=True)
        if self.cfg.relativistic_gan:
            loss = relativistic_d_loss(gt_out, sr_out)
        else:
            loss = _bce_scales(gt_out, 1.0) + _bce_scales(sr_out, 0.0)
        state.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        state.d_opt.step()
        return {
            "d_loss": loss.detach(),
            "d_gt_probability": _mean_sigmoid(gt_out),
            "d_sr_probability": _mean_sigmoid(sr_out),
        }

    def _g_losses(self, state: TrainState, sr: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
        """The G loss parts and their sum, ``g_loss``, with their graphs."""
        cfg = self.cfg
        pixel = _weighted(cfg.pixel_weight, torch.mean(torch.abs(sr - gt)))
        parts = {"pixel_loss": pixel}
        total = pixel
        if self.content_loss is not None:
            parts["content_loss"] = self.content_loss(sr, gt)
            total = total + parts["content_loss"]
        if self.has_d:
            sr_out = _d_train_mode(state.d_model, sr, update_stats=False)
            if cfg.relativistic_gan:
                with torch.no_grad():  # a constant of the G term
                    gt_out = _d_train_mode(state.d_model, gt, update_stats=False)
                adv = relativistic_g_loss(gt_out, sr_out)
            else:
                adv = _bce_scales(sr_out, 1.0)
            parts["adversarial_loss"] = _weighted(cfg.adversarial_weight, adv)
            total = total + parts["adversarial_loss"]
        parts["g_loss"] = total
        return parts

    @torch.inference_mode()
    def eval_sr(self, state: TrainState, lr_img: torch.Tensor) -> torch.Tensor:
        """SR of ``lr_img`` by G (the reference validates the raw generator)."""
        return state.g_model(lr_img)
