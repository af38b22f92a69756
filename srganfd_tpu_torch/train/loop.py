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

The optimizer is optax's ``adamw`` chain of the JAX ``Trainer``
(``srganfd_tpu/train/loop.py:138-160``): ``torch.optim.Adam(lr, betas,
eps=model_eps)``, or ``torch.optim.AdamW`` with ``model_weight_decay`` (the
decoupled ``lr * wd * p`` at the scheduled lr, as ``optax.adamw`` decays;
``Adam(weight_decay=...)`` would be L2 through the gradient), after
``grad_clip_norm``'s ``optax.clip_by_global_norm`` (``g * max / |g|`` only
where ``|g| >= max``; ``clip_grad_norm_`` divides by ``|g| + 1e-6``).
Parameters and Adam states are f32; ``compute_dtype="bfloat16"`` runs G, D
and the VGG in bf16 as Flax's ``dtype`` does (each conv casts its f32
parameters at call time); the losses are f32.

``grad_accum_steps`` = N runs each update phase in N chunks of the batch
and takes one optimizer step on the mean of their gradients (summed, then
divided by N), in the JAX step's order: D's ``u`` and running statistics
advance chunk by chunk, the relativistic means and BatchNorm's batch
statistics are per chunk, the metrics are means over the chunks. A D-first
config feeds D from a forward of G without a graph, then recomputes G chunk
by chunk; a G-first config hands the concatenated per-chunk SR to D.

``skip_nonfinite_updates`` leaves a phase's parameters, Adam state, EMA
(G) or ``u`` and running statistics (D) as they were when its raw
gradients hold a NaN or an Inf, and reports ``g_update_skipped`` /
``d_update_skipped``. The decision is taken on the host, one sync a phase:
a skipped phase never calls its optimizer's ``step``, and D's buffers,
which its train forwards write in place, are restored from a copy taken
before them. ``TrainState.g_count`` / ``d_count`` count the applied
updates, optax's count, which drives the schedules (``state.step``
advances on a skipped step, as the JAX state's does).

Each RDB of the generator is ``ops/cuda/rdb.py`` ``rdb_apply``: the
hand-written kernel on a CUDA tensor, its backward through the plain
version, recomputed, as the JAX ``rdb_apply`` does. The step's parts are
named for ``torch.profiler`` (``utils/profiling.py`` ``annotate``).

Data parallelism (a process group of more than one rank,
``parallel/mesh.py``): each rank steps on its own shard of the global batch
with the whole state. The JAX step is one program over the globally
sharded batch, so each of its batch reductions is a global one; here:

- the gradients are averaged over the ranks after each phase's backward,
  by one explicit all-reduce of the flattened gradients
  (``_apply_update``), before the guard, the clip and Adam, so every rank
  takes the same decision and the same update. With equal per-rank
  batches the mean of the ranks' local-mean gradients is the global
  mean's. DDP is not used: the D-first step differentiates D on real and
  fake in one backward and D's forward in the G loss takes no gradient,
  which DDP's reducer takes for unused parameters without
  ``static_graph``; ``SNConv``'s ``u`` and BatchNorm's running statistics
  are buffers that each rank writes identically from identical
  parameters and all-reduced statistics, where DDP would broadcast rank
  0's; and accumulation would need ``no_sync`` on the micro-steps;
- BatchNorm's batch statistics and the relativistic losses' means are
  all-reduced inside the models and losses (``models/blocks.py``
  ``BatchNorm._batch_moments``, ``losses/gan.py`` ``batch_mean``), with a
  differentiable all-reduce;
- the reported metrics are averaged over the ranks.

With accumulation the JAX step cuts the *global* batch into contiguous
chunks, so a chunk's BatchNorm statistics and relativistic means span
other rows than any rank's chunk: that combination raises (ROADMAP.md
A11) when the ``data`` axis has more than one row. Plain BCE and L1 steps
accumulate exactly.

The mesh (``cfg.mesh_shape``/``cfg.mesh_axes``, ``parallel/mesh.py``): the
ranks of one ``data`` row hold the same shard. A ``pipe`` axis pipelines
G's trunk (``parallel/pipeline.py``, the JAX ``pipelined_full_apply``) in
``pipeline_microbatches`` microbatches (0: one a stage) whenever they
divide the rank's batch, the sequential trunk otherwise (eval's batch of
one), as the JAX ``_g_apply`` does; it needs ``g_kwargs`` with
``scan_blocks``. Each block's gradient then lies on its owner rank: the
trunk's gradients are summed over the ``pipe`` axis before the average
over the ranks, which leaves every rank's whole G, Adam and EMA alike, as
the JAX state stays one whole tree. The other axes replicate the step.
The multi-slice ``dcn_mesh_shape`` raises, naming ROADMAP.md A11.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.losses.content import ContentLoss
from srganfd_tpu_torch.losses.gan import bce_with_logits, relativistic_d_loss, relativistic_g_loss
from srganfd_tpu_torch.models import check_ported, create_model
from srganfd_tpu_torch.models.blocks import BatchNorm, drop_packed
from srganfd_tpu_torch.ops.consts import device_const
from srganfd_tpu_torch.ops.degrade import BsrganPlan, apply_chain_cropped, plan_operands
from srganfd_tpu_torch.parallel import comm
from srganfd_tpu_torch.parallel.mesh import Mesh, make_hybrid_mesh, make_mesh
from srganfd_tpu_torch.parallel.pipeline import pipelined_full_apply
from srganfd_tpu_torch.train.graphs import StepGraphs
from srganfd_tpu_torch.train.schedule import multistep_lr
from srganfd_tpu_torch.train.state import TrainState, ema_update
from srganfd_tpu_torch.utils.profiling import annotate

__all__ = ["Trainer", "COMPUTE_DTYPES"]

# float64, as in the JAX Trainer, exists for lockstep parity tests on the
# CPU (it keeps cross-framework roundoff below what Adam's normalisation
# amplifies); the kernels take f32 and bf16, and raise on f64
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def _weighted(weights: tuple[float, ...], losses: torch.Tensor) -> torch.Tensor:
    """torch.sum(torch.mul(w, losses)) with broadcast semantics
    (``BSRGAN/train_bsrgan.py:450-453``): scalar weight lists scale the
    summed loss; per-node lists dot with per-node losses."""
    w = device_const(np.asarray(weights, np.float32), losses.device)
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
    if cfg.dcn_mesh_shape is not None:
        make_hybrid_mesh()  # raises, naming the item
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


def _adam(model: torch.nn.Module, lr: float, cfg: ExperimentConfig) -> torch.optim.Optimizer:
    """optax's ``adamw(lr, b1, b2, eps, weight_decay)``: Adam without
    weight decay, AdamW's decoupled decay with it."""
    kw = dict(lr=lr, betas=tuple(cfg.model_betas), eps=cfg.model_eps)
    if cfg.model_weight_decay:
        return torch.optim.AdamW(model.parameters(), weight_decay=cfg.model_weight_decay, **kw)
    return torch.optim.Adam(model.parameters(), weight_decay=0.0, **kw)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _all_finite(grads: list[torch.Tensor]) -> bool:
    """Every gradient free of NaN and Inf (the JAX ``_all_finite``): the
    max-norm of a tensor is NaN or Inf exactly when one of its entries is.
    One host sync."""
    if not grads:
        return True
    return bool(torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all())


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and on the device:
    ``g / |g| * max`` where the global norm ``|g| >= max``, ``g`` as it is
    below."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _all_reduce_in_place(tensors: list[torch.Tensor], group: comm.Group = None) -> None:
    """Every tensor replaced, in place, by its sum over ``group`` (every
    rank when None): one all-reduce of them flattened into one buffer."""
    if not tensors:
        return
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group=group)
    for t, s in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(s.view_as(t))


def _sum_over(params: list[torch.nn.Parameter], group: comm.Group) -> None:
    """Every parameter's gradient summed over ``group``, a parameter without
    one taken as zeros (a pipeline stage's blocks that another rank owns)."""
    for q in params:
        if q.grad is None:
            q.grad = torch.zeros_like(q)
    _all_reduce_in_place([q.grad for q in params], group)


def _average_over_ranks(grads: list[torch.Tensor]) -> None:
    """Every rank's gradients replaced, in place, by their mean over the
    ranks."""
    if grads:
        _all_reduce_in_place(grads)
        torch._foreach_div_(grads, float(comm.world()))


def _mean_of(per_chunk: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    if len(per_chunk) == 1:
        return per_chunk[0]
    return {k: torch.stack([m[k] for m in per_chunk]).mean(0) for k in per_chunk[0]}


# -- the device form of the update (the dispatch modes) ----------------------
#
# A captured CUDA graph replays device work only: no host read of a value and
# no host branch on one. The device form of a step keeps on the card what the
# host form decides on the host: the learning rate (a table indexed by the
# applied-update count), the guard's decision (a 0-d bool that selects new or
# old tensors), Adam's bias corrections, the EMA's first-step copy and the
# counts. Its scalars are f64, as the host form's Python floats are.


def _finite_device(grads: list[torch.Tensor]) -> torch.Tensor:
    """0-d bool on the device: every gradient free of NaN and Inf."""
    return torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()


@torch.no_grad()
def _select(finite: torch.Tensor | None, tensors: list[torch.Tensor], old: list[torch.Tensor] | None) -> None:
    """Where ``finite`` is False, put ``old`` back into ``tensors``, in place."""
    if finite is not None:
        for t, o in zip(tensors, old):
            t.copy_(torch.where(finite, t, o))


@torch.no_grad()
def _adam_device(opt: torch.optim.Optimizer, lr: torch.Tensor, finite: torch.Tensor | None) -> None:
    """``opt``'s Adam (or AdamW's decoupled decay) update with the learning
    rate ``lr`` a 0-d f64 tensor on the device, on the optimizer's own state
    (``step``, ``exp_avg``, ``exp_avg_sq``: its state dict stays
    ``torch.optim.Adam``'s, with ``step`` on the parameters' device), in
    torch's arithmetic: the moments by lerp and addcmul, then ``p -= lr /
    (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``. With ``finite``
    every tensor it writes keeps its old value where ``finite`` is False."""
    group = opt.param_groups[0]
    (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
    params = [p for p in group["params"] if p.grad is not None]
    grads = [p.grad for p in params]
    for p in params:
        s = opt.state[p]
        if not s:
            s["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            s["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            s["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif s["step"].device != p.device:
            s["step"] = s["step"].to(p.device)
    steps = [opt.state[p]["step"] for p in params]
    ms = [opt.state[p]["exp_avg"] for p in params]
    vs = [opt.state[p]["exp_avg_sq"] for p in params]
    written = params + ms + vs + steps
    old = [t.clone() for t in written] if finite is not None else None
    torch._foreach_add_(steps, 1.0)
    t = steps[0].double()
    if wd:
        if isinstance(opt, torch.optim.AdamW):
            torch._foreach_mul_(params, 1.0 - lr * wd)
        else:
            grads = torch._foreach_add(grads, params, alpha=wd)
    torch._foreach_lerp_(ms, grads, 1.0 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
    step_size = lr / (1.0 - torch.pow(b1, t))
    denom = torch._foreach_sqrt(vs)
    torch._foreach_div_(denom, torch.sqrt(1.0 - torch.pow(b2, t)))
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(ms, denom)
    torch._foreach_mul_(update, -step_size)
    torch._foreach_add_(params, update)
    _select(finite, written, old)


class DeviceCounts:
    """The step and the applied-update counts of G and D as int64 tensors
    on the device, and the schedules as tables of their values indexed by
    the milestones passed: what a device-form step reads and advances. One
    set a trainer, so that a captured graph holds them for good;
    :meth:`Trainer.sync_counts` writes them back to the state."""

    def __init__(self, trainer: "Trainer") -> None:
        dev, ms = trainer.device, sorted(trainer.milestones)
        self.milestones = torch.tensor(ms, dtype=torch.int64, device=dev)
        self.tables = {
            which: torch.tensor([sched(0)] + [sched(m) for m in ms], dtype=torch.float64, device=dev)
            for which, sched in (("g", trainer.schedule), ("d", trainer.d_schedule))
        }
        self.step, self.g, self.d = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))
        self.state: TrainState | None = None
        self.host_step = -1  # state.step when the counts were last loaded or advanced

    def load(self, state: TrainState) -> None:
        """Take the counts from ``state`` (in place: graphs hold the tensors)."""
        self.step.fill_(state.step)
        self.g.fill_(state.g_count)
        self.d.fill_(state.d_count)
        self.state, self.host_step = state, state.step

    def lr(self, which: str) -> torch.Tensor:
        """The scheduled lr of ``which`` ("g" or "d") at its applied-update count."""
        count = self.g if which == "g" else self.d
        passed = (count >= self.milestones).sum().reshape(1)
        return self.tables[which].index_select(0, passed).reshape(())  # a tensor index: no host read

    def applied(self, which: str, finite: torch.Tensor | None) -> None:
        count = self.g if which == "g" else self.d
        count.add_(1 if finite is None else finite.to(torch.int64))


class Trainer:
    """Builds the models, the losses and the optimizers from an
    ExperimentConfig and exposes ``train_step`` and ``eval_sr``."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        steps_per_epoch: int = 1000,
        device: torch.device | str = "cpu",
        mesh: Mesh | None = None,
    ) -> None:
        """``mesh``: the one ``cli.train`` made of ``cfg``'s mesh fields
        before its datasets (``make_mesh`` is a collective); made here when
        None."""
        _reject_unported(cfg)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, cfg.mesh_axes)
        self.microbatches = 0  # the pipe axis's M; 0 without one
        if "pipe" in self.mesh.axes:
            if not cfg.g_kwargs.get("scan_blocks", False):
                raise ValueError(
                    "a 'pipe' mesh axis needs the scanned trunk layout: set "
                    "g_kwargs={'scan_blocks': True} (RRDB-trunk generators only)"
                )
            self.microbatches = cfg.pipeline_microbatches or self.mesh.size("pipe")
        self.device = torch.device(device)
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        milestones = tuple(m * steps_per_epoch for m in cfg.milestones_epochs)
        self.milestones = milestones
        self.schedule = multistep_lr(cfg.model_lr, milestones, cfg.lr_scheduler_gamma)
        self.d_schedule = multistep_lr(cfg.discriminator_lr or cfg.model_lr, milestones,
                                       cfg.lr_scheduler_gamma)
        self.has_d = cfg.is_gan
        self.accum = max(1, int(cfg.grad_accum_steps))
        self.guard = bool(cfg.skip_nonfinite_updates)
        self.world = comm.world()
        # the dispatch modes: on the card each dispatch replays a CUDA graph
        # (train/graphs.py) unless this is False (the eager twin it is held to)
        self.cuda_graphs = self.device.type == "cuda"
        self._counts: DeviceCounts | None = None
        self._graphs = None
        self._graphs_state: TrainState | None = None
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
            batchnorm = any(isinstance(m, BatchNorm) for m in d.modules())
            if self.mesh.size("data") > 1 and self.accum > 1 and (cfg.relativistic_gan or batchnorm):
                raise NotImplementedError(
                    "grad_accum_steps > 1 under data parallelism with a BatchNorm D or the relativistic loss: "
                    "the JAX step takes each chunk's statistics over a slice of the global batch that no "
                    "rank holds; not ported: see ROADMAP.md A11"
                )
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
        for a GAN, the D's loss and mean probabilities; with
        ``skip_nonfinite_updates`` the ``*_update_skipped`` flags) as 0-d
        tensors on the device (reading one waits for the step). The pixel
        and content terms target ``gt_pixel`` when given, D's real input is
        ``gt``."""
        metrics = self._step(state, gt, lr_img, gt_pixel)
        state.step += 1
        if self.world > 1:  # the global batch's metrics: the mean of the ranks' (equal batches)
            keys = sorted(metrics)
            dt = torch.float64 if any(v.dtype == torch.float64 for v in metrics.values()) else torch.float32
            mean = comm.all_reduce(torch.stack([metrics[k].to(dt) for k in keys])) / self.world
            metrics = {k: m.to(metrics[k].dtype) for k, m in zip(keys, mean.unbind(0))}
        return metrics

    def _step(
        self,
        state: TrainState,
        gt: torch.Tensor,
        lr_img: torch.Tensor,
        gt_pixel: torch.Tensor | None,
        dev: DeviceCounts | None = None,
    ) -> dict[str, torch.Tensor]:
        """One step's updates and metrics, without advancing ``state.step``:
        the host form (``dev`` None), or the device form that reads and
        advances ``dev``'s counts on the card."""
        target = gt if gt_pixel is None else gt_pixel
        metrics: dict[str, torch.Tensor] = {}
        if not self.has_d:
            parts, _ = self._g_update(state, target, lr_img, dev=dev)
        elif self.cfg.g_step_first:
            parts, sr = self._g_update(state, target, lr_img, dev=dev)
            # the same SR, from G before its update, against the old D's
            # update, as the JAX step's d_update(state, gt, sr) takes it
            metrics = self._d_update(state, gt, sr, dev=dev)
        elif self.accum == 1:
            # one generator forward, whose graph both updates share
            with annotate("g_forward"):
                sr = self._g_apply(state.g_model, lr_img)
            metrics = self._d_update(state, gt, sr.detach(), dev=dev)
            parts, _ = self._g_update(state, target, lr_img, sr=sr, dev=dev)
        else:
            # accumulation: the full batch's graph would pin what the chunks
            # exist to free, so D takes a forward without one (the JAX step's
            # residual-free forward) and the G phase recomputes by chunk
            with annotate("g_forward"), torch.no_grad():
                sr = self._g_apply(state.g_model, lr_img)
            metrics = self._d_update(state, gt, sr, dev=dev)
            parts, _ = self._g_update(state, target, lr_img, dev=dev)
        if dev is not None:
            dev.step.add_(1)
        metrics.update(parts)
        return metrics

    def _pipelined(self, rows: int) -> bool:
        """Whether G's trunk runs pipelined on a batch of ``rows`` frames:
        on a pipe axis whose microbatches divide it."""
        return self.microbatches > 0 and rows % self.microbatches == 0

    def _g_apply(self, model: torch.nn.Module, lr_img: torch.Tensor) -> torch.Tensor:
        """G's forward: the pipelined trunk where :meth:`_pipelined`, else
        the module's own (the JAX ``_g_apply``)."""
        if self._pipelined(lr_img.shape[0]):
            return pipelined_full_apply(model, self.mesh, microbatches=self.microbatches)(lr_img)
        return model(lr_img)

    def _chunks(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The batch in ``grad_accum_steps`` chunks (the JAX ``_chunk``)."""
        if x.shape[0] % self.accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum_steps {self.accum}")
        return torch.split(x, x.shape[0] // self.accum)

    def _apply_update(self, opt: torch.optim.Optimizer, params: list[torch.nn.Parameter]) -> bool:
        """The optimizer step on the accumulated gradients: their mean over
        the chunks, the guard's check of the raw mean, the clip, Adam.
        Returns whether it was applied."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        if self.world > 1:
            _average_over_ranks(grads)
        if self.guard and not _all_finite(grads):
            return False
        if self.cfg.grad_clip_norm:
            _clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        opt.step()
        return True

    def _apply_update_device(self, opt: torch.optim.Optimizer, params: list[torch.nn.Parameter],
                             dev: DeviceCounts, which: str) -> torch.Tensor | None:
        """:meth:`_apply_update` in the device form: the guard's decision a
        0-d bool on the device (None without the guard) that the update
        selects on, the lr from ``dev``'s table for ``which``'s count."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        finite = _finite_device(grads) if self.guard else None
        if self.cfg.grad_clip_norm:
            _clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        _adam_device(opt, dev.lr(which), finite)
        return finite

    def _skipped(self, applied: bool | torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if isinstance(applied, torch.Tensor):
            return (~applied).to(torch.float32)
        return torch.tensor(0.0 if applied else 1.0, dtype=torch.float32, device=like.device)

    def _g_update(
        self,
        state: TrainState,
        target: torch.Tensor,
        lr_img: torch.Tensor,
        sr: torch.Tensor | None = None,
        dev: DeviceCounts | None = None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """The G update: the losses against the current D, their backward
        into G only (D and the VGG are constants of it), Adam on G, then the
        EMA. ``sr`` is a forward with its graph to reuse (the D-first step's
        shared forward); else G runs here, by chunk under accumulation.
        Returns the loss parts and the detached SR of the phase. ``dev``:
        the device form."""
        if dev is None:
            _set_lr(state.g_opt, self.schedule(state.g_count))  # optax's count: updates applied before
        params = list(state.g_model.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        per_chunk, srs = [], []
        with annotate("g_update"):
            if sr is not None:
                pairs = [(sr, target, None)]
            else:
                pairs = [(None, t_i, lr_i) for t_i, lr_i in zip(self._chunks(target), self._chunks(lr_img))]
            for sr_i, t_i, lr_i in pairs:
                if sr_i is None:
                    with annotate("g_forward"):
                        sr_i = self._g_apply(state.g_model, lr_i)
                parts = self._g_losses(state, sr_i, t_i)
                parts["g_loss"].backward(inputs=params)
                per_chunk.append({k: v.detach() for k, v in parts.items()})
                srs.append(sr_i.detach())
            if self._pipelined(srs[0].shape[0]):  # each block's gradient lies on its owner rank
                _sum_over(list(state.g_model.trunk.parameters()), self.mesh.group("pipe"))
            if dev is not None:
                applied = self._apply_update_device(state.g_opt, params, dev, "g")
            else:
                applied = self._apply_update(state.g_opt, params)
        if dev is not None:
            with annotate("ema"):
                ema = list(state.ema_g.values())
                old = [e.clone() for e in ema] if applied is not None else None
                ema_update(state.ema_g, dict(state.g_model.named_parameters()), self.cfg.model_ema_decay,
                           reference_semantics=self.cfg.ema_reference_semantics, step=dev.step)
                _select(applied, ema, old)
            dev.applied("g", applied)
        elif applied:
            with annotate("ema"):
                ema_update(
                    state.ema_g, dict(state.g_model.named_parameters()), self.cfg.model_ema_decay,
                    reference_semantics=self.cfg.ema_reference_semantics, step=state.step,
                )
            state.g_count += 1
        parts = _mean_of(per_chunk)
        if self.guard:
            parts["g_update_skipped"] = self._skipped(applied, srs[0])
        return parts, srs[0] if len(srs) == 1 else torch.cat(srs)

    def _d_update(self, state: TrainState, gt: torch.Tensor, sr: torch.Tensor,
                  dev: DeviceCounts | None = None) -> dict[str, torch.Tensor]:
        """BCE(D(gt), 1) + BCE(D(sr), 0), or with ``relativistic_gan`` the
        relativistic average loss of the same two forwards, with ``u`` and
        the running statistics advanced by each train forward, then Adam on
        D; by chunk under accumulation."""
        d = state.d_model
        if dev is None:
            _set_lr(state.d_opt, self.d_schedule(state.d_count))
        # the train forwards write u and the running statistics in place:
        # the guard keeps a copy to restore on a skip
        saved = [b.detach().clone() for b in d.buffers()] if self.guard else None
        params = list(d.parameters())
        state.d_opt.zero_grad(set_to_none=True)
        per_chunk = []
        with annotate("d_update"):
            for gt_i, sr_i in zip(self._chunks(gt), self._chunks(sr)):
                loss, gt_out, sr_out = self._d_loss(d, gt_i, sr_i)
                loss.backward()
                per_chunk.append({
                    "d_loss": loss.detach(),
                    "d_gt_probability": _mean_sigmoid(gt_out),
                    "d_sr_probability": _mean_sigmoid(sr_out),
                })
            if dev is not None:
                applied = self._apply_update_device(state.d_opt, params, dev, "d")
            else:
                applied = self._apply_update(state.d_opt, params)
        if dev is not None:
            _select(applied, list(d.buffers()), saved)
            dev.applied("d", applied)
        elif applied:
            state.d_count += 1
        elif saved is not None:
            with torch.no_grad():
                for b, old in zip(d.buffers(), saved):
                    b.copy_(old)
        metrics = _mean_of(per_chunk)
        if self.guard:
            metrics["d_update_skipped"] = self._skipped(applied, gt)
        return metrics

    def _d_loss(self, d: torch.nn.Module, gt: torch.Tensor, sr: torch.Tensor) -> tuple[torch.Tensor, Logits, Logits]:
        """D's loss on one (gt, detached sr) pair and its two outputs."""
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
        return loss, gt_out, sr_out

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
        """SR of ``lr_img`` by G (the reference validates the raw generator);
        pipelined where the batch divides into the microbatches, so the
        ranks of a pipe axis call it alike."""
        return self._g_apply(state.g_model, lr_img)

    # -- the dispatch modes: the degradation-fused step and K-step dispatch --

    def sync_counts(self, state: TrainState) -> None:
        """Write the device form's applied-update counts back to ``state``
        (one read of the card): before a checkpoint or any host read of
        ``state.g_count`` / ``state.d_count`` after dispatches."""
        if self._counts is not None and self._counts.state is state:
            state.g_count, state.d_count = int(self._counts.g), int(self._counts.d)

    def _dispatch(self, state: TrainState, key: tuple, fn: Callable, inputs: list[torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """Run one dispatch of ``len(inputs[0])`` device-form steps: a CUDA
        graph's replay on the card (:mod:`train.graphs`), eagerly otherwise."""
        if self.world > 1 or self.microbatches:
            raise NotImplementedError("the dispatch modes run in a world of one rank (cli.train runs one step at "
                                      "a time under data parallelism, as the JAX CLI does under multi-host)")
        self._counts_for(state)
        if self._counts.state is not state or self._counts.host_step != state.step:
            self._counts.load(state)
        if self.device.type == "cuda" and self.cuda_graphs:
            if self._graphs is None or self._graphs_state is not state:
                self._graphs = StepGraphs(self.device, after_replay=lambda: drop_packed(state.g_model))
                self._graphs_state = state
            metrics = self._graphs.run(key, fn, inputs)
        else:
            metrics = fn(inputs)
        state.step += inputs[0].shape[0]
        self._counts.host_step = state.step
        return metrics

    def graph_stats(self) -> dict:
        """The dispatch graphs' counts (empty where none was captured)."""
        return self._graphs.stats() if self._graphs is not None else {}

    def _device_tensor(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return t.to(self.device, non_blocking=True)

    def bsrgan_fused_train_step(self, state: TrainState, gt_raw, plan: BsrganPlan, tops, lefts,
                                gt_size: int) -> dict[str, torch.Tensor]:
        """The BSRGAN chain, the aligned crop and the update as one dispatch
        (the JAX ``bsrgan_fused_train_step``): one graph replay a step on the
        card, one graph a branch key ``(scale2, scale2_interp,
        effective_upscale)``. ``plan`` needs the per-sample JPEG slot
        (``plan_bsrgan_batch(..., per_sample_order=True)``), ``gt_raw`` is
        uint8 or float, ``tops``/``lefts`` LR-space offsets."""
        return self.bsrgan_fused_train_multi_step(state, [gt_raw], [plan], [tops], [lefts], gt_size)

    def bsrgan_fused_train_multi_step(self, state: TrainState, gt_raws, plans: list[BsrganPlan], tops_list,
                                      lefts_list, gt_size: int) -> dict[str, torch.Tensor]:
        """K fused steps, each with its own chain and crop, as one dispatch
        (the JAX ``bsrgan_fused_train_multi_step``); the K plans share one
        branch key (the caller groups steps by it). Each step's numerics are
        K single fused steps'; the metrics returned are their mean."""
        first = plans[0]
        skey = (first.scale2, first.scale2_interp, first.effective_upscale)
        if any((p.scale2, p.scale2_interp, p.effective_upscale) != skey for p in plans):
            raise ValueError("all plans in a multi-step dispatch must share the static branch")
        ops = [plan_operands(p) for p in plans]
        names = ("kernels_a", "kernels_b", "jpeg_quality", "jpeg_apply", "final_jpeg_quality", "jpeg_pos")
        gts = torch.stack([self._device_tensor(g) for g in gt_raws])
        inputs = [gts, *(self._device_tensor(np.stack([o[n] for o in ops])) for n in names),
                  *(self._device_tensor(np.stack([np.asarray(t, np.int64) for t in ts])) for ts in (tops_list,
                                                                                                lefts_list))]
        sf = self.cfg.upscale_factor
        dev = self._counts_for(state)

        def fused(xs: list[torch.Tensor]) -> dict[str, torch.Tensor]:
            per_step = []
            for k in range(xs[0].shape[0]):
                gt_c, lr_c = apply_chain_cropped(*(x[k] for x in xs), *skey, gt_size, sf)
                per_step.append(self._step(state, gt_c, lr_c, None, dev))
            return _mean_of(per_step)

        key = ("fused", skey, gt_size, tuple(gts.shape), gts.dtype)
        return self._dispatch(state, key, fused, inputs)

    def make_train_multi_step(self, separate_pixel_target: bool = False) -> Callable:
        """K pre-degraded steps of any family as one dispatch (the JAX
        ``make_train_multi_step``): ``(state, batches) -> metrics`` with
        ``batches`` K dicts ``{"gt", "lr"[, "gt_pixel"]}`` (the adapter's);
        each step's numerics are K single steps' in the device form; the
        metrics returned are their mean. One graph per K and batch shape."""
        names = ("gt", "lr", "gt_pixel") if separate_pixel_target else ("gt", "lr")

        def multi(state: TrainState, batches) -> dict[str, torch.Tensor]:
            inputs = [torch.stack([self._device_tensor(b[n]) for b in batches]) for n in names]
            dev = self._counts_for(state)

            def steps(xs: list[torch.Tensor]) -> dict[str, torch.Tensor]:
                per_step = []
                for k in range(xs[0].shape[0]):
                    per_step.append(self._step(state, xs[0][k], xs[1][k],
                                               xs[2][k] if separate_pixel_target else None, dev))
                return _mean_of(per_step)

            key = ("plain", names, *((tuple(x.shape), x.dtype) for x in inputs))
            return self._dispatch(state, key, steps, inputs)

        return multi

    def _counts_for(self, state: TrainState) -> DeviceCounts:
        if self._counts is None:
            self._counts = DeviceCounts(self)
        return self._counts
