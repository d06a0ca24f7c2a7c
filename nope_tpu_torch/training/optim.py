"""Optimizer and learning-rate schedule of the reference recipe
(``nope_tpu/training/optim.py``).

- AdamW, lr 5e-5, weight_decay 5e-4 (SGD with momentum 0.9 as the
  alternative), as ``torch.optim.AdamW`` / ``torch.optim.SGD``: optax's
  ``adamw`` decays decoupled by lr·wd and adds eps to √v̂, as AdamW does;
  its ``add_decayed_weights`` + ``sgd(momentum=0.9)`` is SGD with
  ``weight_decay`` and no dampening.
- a linear warm-up over ``warm_up_steps`` updates, then MultiStepLR over
  epochs (×0.5 at epochs 10, 30, 50, 100), with the reference's quirks.
- optional global-norm clipping (optax's factor ``c / max(‖g‖, c)``) and
  skipping of spike steps (:class:`SkipSpike`).

:class:`Optimizer` wraps the ``torch.optim`` optimizer with what optax
keeps in its state: the update count the schedule reads (the count
*before* the update, so the first update uses ``schedule(0)``; a skipped
step does not advance it, as optax leaves its inner state untouched),
the clipping and the skip-spike state.  Under data parallelism the
train step averages ``.grad`` over the ranks first, so the clip factor
and the skip-spike decision, read from the averaged gradients, are the
same on every rank; :meth:`Optimizer.shard` makes the inner optimizer
ZeRO-1 (``parallel.zero``).
"""

from __future__ import annotations

import inspect
from typing import Callable, Iterable, List, Optional, Sequence

import torch


def make_lr_schedule(
    base_lr: float = 5e-5,
    warm_up_steps: int = 500,
    milestones_epochs: Sequence[int] = (10, 30, 50, 100),
    gamma: float = 0.5,
    steps_per_epoch: Optional[int] = None,
) -> Callable[[int], float]:
    """The learning rate as a function of the update count, in float32
    as the JAX package computes it.  As the reference drives MultiStepLR
    (``nope_tpu/training/optim.py:40-48``): milestones whose epoch ends
    inside the warm-up are lost, and after the warm-up the base is the
    last warm-up value, (w-1)/w · lr, not lr."""
    milestone_steps = (
        sorted(int(e * steps_per_epoch) for e in milestones_epochs) if steps_per_epoch else None
    )
    w = max(int(warm_up_steps), 0)

    def schedule(step: int) -> float:
        # float32 arithmetic, each operation rounded as jnp rounds it
        step = int(step)
        factor = 1.0
        if milestone_steps is not None:
            applied = sum(1 for m in milestone_steps if m >= w and step >= m)
            factor = torch.tensor(gamma, dtype=torch.float32) ** applied
        if w <= 0:
            return float(torch.tensor(base_lr, dtype=torch.float32) * factor)
        if step < w:
            return float(torch.tensor(step, dtype=torch.float32) / w * base_lr)
        return float(torch.tensor(base_lr * (w - 1) / w, dtype=torch.float32) * factor)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√Σ‖t‖² over ``tensors`` in float32, on their device (no host read)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class SkipSpike:
    """The state of ``skip_spike_updates`` (``nope_tpu/training/optim.py:63-126``):
    a step whose raw gradient global norm exceeds ``factor`` × the
    bias-corrected EMA of the earlier norms is skipped outright (no
    parameter motion, the inner optimizer untouched), and the spike does
    not enter the EMA.  No step within the first ``warmup_steps`` is
    skipped.

    The EMA stays on the device; the decision is one host read of a
    boolean per step, and only past the warm-up."""

    def __init__(self, factor: float = 20.0, norm_ema: float = 0.99, warmup_steps: int = 200,
                 device: Optional[torch.device] = None):
        self.factor, self.norm_ema, self.warmup_steps = float(factor), float(norm_ema), int(warmup_steps)
        self.gnorm_ema = torch.zeros((), dtype=torch.float32, device=device)
        self.count = 0

    def observe(self, g: torch.Tensor) -> bool:
        """Take this step's raw gradient norm ``g``; True if it is a spike."""
        spike = False
        if self.count >= self.warmup_steps:
            beta = torch.tensor(self.norm_ema, dtype=torch.float32, device=g.device)
            ref = self.gnorm_ema / (1.0 - beta ** float(max(self.count, 1)))
            spike = bool(g > self.factor * ref)
        if not spike:
            self.gnorm_ema = self.gnorm_ema * self.norm_ema + (1.0 - self.norm_ema) * g
        self.count += 1
        return spike

    def state_dict(self) -> dict:
        return {"gnorm_ema": self.gnorm_ema.detach().cpu(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.gnorm_ema = state["gnorm_ema"].to(self.gnorm_ema.device, torch.float32)
        self.count = int(state["count"])


class Optimizer:
    """A ``torch.optim`` optimizer over ``params`` with the schedule,
    optional clipping and optional skip-spike state of
    :func:`make_optimizer`.  :meth:`step` reads the parameters' ``.grad``."""

    def __init__(self, params: Iterable[torch.Tensor], inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float], clip_grad_norm: float = 0.0,
                 skip_spike: Optional[SkipSpike] = None):
        self.params: List[torch.Tensor] = list(params)
        self.inner = inner
        self.schedule = schedule
        self.clip_grad_norm = float(clip_grad_norm or 0.0)
        self.skip_spike = skip_spike
        self.count = 0  # applied updates: what the schedule reads
        self.sharded = False  # ZeRO-1 (shard)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def shard(self, group) -> None:
        """Make the inner optimizer ZeRO-1 over ``group``
        (``ZeroRedundancyOptimizer`` of the same class and settings):
        each rank then keeps the state of its part of the parameters and
        broadcasts that part after its update.  Before the first step."""
        from torch.distributed.optim import ZeroRedundancyOptimizer

        if self.inner.state:
            raise ValueError("shard the optimizer before its first step")
        cls = type(self.inner)
        accepted = inspect.signature(cls.__init__).parameters
        settings = {k: v for k, v in self.inner.defaults.items() if k in accepted}
        self.inner = ZeroRedundancyOptimizer(self.params, optimizer_class=cls, process_group=group, **settings)
        self.sharded = True

    def step(self) -> bool:
        """One update from the current ``.grad`` (missing ones read as
        zero).  Returns False where the step was skipped as a spike."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.skip_spike is not None or self.clip_grad_norm > 0:
            g_norm = global_norm(grads)
            if self.skip_spike is not None and self.skip_spike.observe(g_norm):
                return False
            if self.clip_grad_norm > 0:
                c = torch.tensor(self.clip_grad_norm, dtype=torch.float32, device=g_norm.device)
                torch._foreach_mul_(grads, c / torch.maximum(g_norm, c))
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The inner optimizer's state, the count and the skip-spike state.
        ZeRO-1: a collective; the state is gathered onto rank 0, and the
        other ranks' ``inner`` is None."""
        if self.sharded:
            self.inner.consolidate_state_dict(to=0)
            inner = self.inner.state_dict() if torch.distributed.get_rank() == 0 else None
        else:
            inner = self.inner.state_dict()
        return {
            "inner": inner,
            "count": self.count,
            "skip_spike": None if self.skip_spike is None else self.skip_spike.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        """From :meth:`state_dict`'s whole state (under ZeRO-1 each rank
        keeps its part of it)."""
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        if (state["skip_spike"] is None) != (self.skip_spike is None):
            raise ValueError("the checkpoint's skip-spike state does not match this optimizer's")
        if self.skip_spike is not None:
            self.skip_spike.load_state_dict(state["skip_spike"])


def make_optimizer(
    params: Iterable[torch.Tensor],
    optim_name: str = "AdamW",
    base_lr: float = 5e-5,
    weight_decay: float = 5e-4,
    warm_up_steps: int = 500,
    milestones_epochs: Sequence[int] = (10, 30, 50, 100),
    gamma: float = 0.5,
    steps_per_epoch: Optional[int] = None,
    clip_grad_norm: float = 0.0,
    skip_spike_factor: float = 0.0,
) -> Optimizer:
    """The JAX package's ``make_optimizer`` over ``params``.
    ``clip_grad_norm`` > 0 clips by the global norm first;
    ``skip_spike_factor`` > 0 wraps the whole chain in :class:`SkipSpike`
    (its norm is the raw, unclipped one)."""
    params = list(params)
    schedule = make_lr_schedule(base_lr, warm_up_steps, milestones_epochs, gamma, steps_per_epoch)
    if optim_name == "SGD":
        inner = torch.optim.SGD(params, lr=schedule(0), momentum=0.9, dampening=0.0,
                                weight_decay=weight_decay, foreach=True)
    elif optim_name == "AdamW":
        inner = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay, foreach=True)
    else:
        raise ValueError(optim_name)
    skip = None
    if skip_spike_factor and skip_spike_factor > 0:
        skip = SkipSpike(factor=skip_spike_factor, device=params[0].device if params else None)
    return Optimizer(params, inner, schedule, clip_grad_norm, skip)


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], new_params: Sequence[torch.Tensor],
               beta: float = 0.995) -> None:
    """ema ← beta·ema + (1-beta)·new, in place (``model_utils.py:175-195``)."""
    ema, new = list(ema_params), [p.detach() for p in new_params]
    torch._foreach_mul_(ema, beta)
    torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - beta))
