"""ICV training objective, optimizer and train step (counterpart of
``licv_vqa_tpu/icv/module.py``).

Teacher = the frozen LMM on the full few-shot ICL prompt (no ICV, no
gradient); student = the same LMM zero-shot with the ICV injected; loss =
masked temperature-KL on the answer-token logits (+ optional hard CE)
(reference icv_src/icv_module.py).  Only ``(icv, alpha)`` and the
temperature are trainable; the LMM's weights never get ``requires_grad``.

The optimizer is ``torch.optim.AdamW`` driven to optax's semantics, as the
JAX package chains them (``make_optimizer``): three groups (``icv`` at
``icv_lr``, ``alpha`` at ``alpha_lr``, ``temperature`` at ``icv_lr`` with no
weight decay), a transformers-style cosine schedule with warmup per group,
the global-norm clip taken jointly over all groups before them, and
``optax.MultiSteps`` accumulation: micro-batch gradients are averaged and
the inner optimizer (and its schedule counter) advances once per
``accumulate_grad_batches`` micro-batches.

Over a dp-split batch (``parallel/sharding.py``: each rank its contiguous
rows of one global batch) the losses divide by the GLOBAL denominators
(an all-reduce of the ranks' counts), so each rank's loss is its share of
JAX's global-batch loss; the ``(icv, alpha, T)`` gradients and the logged
losses are summed over dp, and the clip takes the norm of the summed
gradients.  Under tp every rank of a group computes the same loss (the
logits are gathered whole) and the same gradients.  Under sp every rank of
a group computes the same loss too (the post-norm hidden is gathered whole
before the head, ``parallel/ring.py``), but the ``(icv, alpha)`` gradient
of each is the part its chunk of tokens carries, so those are summed over
dp × sp; the temperature enters after the gather, its gradient is whole on
every sp rank and is summed over dp alone.  The clip then sees JAX's global
norm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops.kl import (
    aligned_teacher_gather,
    answer_region_mask,
    masked_kl_divergence,
    shifted_cross_entropy,
)
from ..parallel.sharding import all_reduce_dp, all_reduce_grad, dp_size, sp_size
from .encoder import GlobalICVEncoder


@dataclasses.dataclass(frozen=True)
class ICVModuleConfig:
    """Mirror of config/icv_module/icv_module.yaml (reference keys)."""

    hard_loss_weight: float = 0.0
    only_hard_loss: bool = False
    init_temperature: float = 1.0
    decay_ratio: float = -1.0
    decay_per_step: float = -1.0
    min_temperature: float = 1.0
    learnable_t: bool = False
    kl_eps: float = 1e-6
    kl_impl: str = "xla"  # "xla" (plain) | "pallas" (the fused Triton kernels)
    log_alpha: bool = True
    # True: pad positions are left out of the hard CE; False: the
    # reference's raw labels (pads included, icv_src/icv_module.py:94-98)
    mask_ce_padding: bool = True
    alpha_lr: float = 1e-2
    icv_lr: float = 1e-4
    weight_decay: float = 1e-3
    warm_steps: float = 0.1
    gradient_clip_val: float = 1.0
    accumulate_grad_batches: int = 1

    @classmethod
    def from_config(cls, cfg, trainer_cfg=None) -> "ICVModuleConfig":
        kw = dict(
            hard_loss_weight=float(cfg.get("hard_loss_weight", 0.0)),
            only_hard_loss=bool(cfg.get("only_hard_loss", False)),
            init_temperature=float(cfg.get("init_temperature", 1.0)),
            decay_ratio=float(cfg.get("decay_ratio", -1)),
            decay_per_step=float(cfg.get("decay_per_step", -1)),
            # the reference config key is misspelt "min_tmeprature"
            min_temperature=float(cfg.get("min_tmeprature", cfg.get("min_temperature", 1.0))),
            learnable_t=bool(cfg.get("learnable_t", False)),
            kl_eps=float(cfg.get("kl_eps", 1e-6)),
            kl_impl=str(cfg.get("kl_impl", "xla")),
            log_alpha=bool(cfg.get("log_alpha", True)),
            mask_ce_padding=bool(cfg.get("mask_ce_padding", True)),
            alpha_lr=float(cfg.get("alpha_lr", 1e-2)),
            icv_lr=float(cfg.get("icv_lr", 1e-4)),
            weight_decay=float(cfg.get("weight_decay", 1e-3)),
            warm_steps=float(cfg.get("warm_steps", 0.1)),
        )
        if trainer_cfg is not None:
            kw["gradient_clip_val"] = float(trainer_cfg.get("gradient_clip_val", 1.0))
            kw["accumulate_grad_batches"] = int(trainer_cfg.get("accumulate_grad_batches", 1))
        return cls(**kw)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def icv_loss_fn(
    encoder: GlobalICVEncoder,
    temperature: torch.Tensor,  # f32 scalar
    model_params: Any,  # frozen LMM params
    batch: dict,  # query_inputs / inputs / query_x_length / in_context_length
    forward_fn: Callable,  # (model_params, inputs, icv_scaled, **kw) -> logits
    cfg: ICVModuleConfig,
    pad_token_id: int,
    head_fn: Optional[Callable] = None,  # (model_params, hidden) -> logits
) -> tuple[torch.Tensor, dict]:
    """Reference forward semantics (icv_src/icv_module.py:71-119); returns
    ``(loss, metrics)``.

    ``head_fn``: the teacher runs to its post-norm hidden states, gathers
    the student-aligned window, and only then applies the LM head, so the
    (B, S_tea, V) f32 teacher logits never exist (the head is per position,
    so it commutes with the gather)."""
    icv_scaled = encoder.scaled_icv()  # (L, D)
    query_inputs = batch["query_inputs"]
    stu_logits = forward_fn(model_params, query_inputs, icv_scaled)  # (B, Ss, V) f32

    # rows padded to fill a batch have an all-zero attention mask: inert in
    # both losses (a real row attends to at least one token)
    attn = query_inputs["attention_mask"].bool()
    row_valid = attn.any(dim=1)
    metrics: dict = {}
    loss = torch.zeros((), dtype=torch.float32, device=stu_logits.device)

    def global_count(w):  # the global batch's denominator (dp), else None
        return all_reduce_dp(torch.sum(w.float())) if dp_size() > 1 else None

    if cfg.hard_loss_weight or cfg.only_hard_loss:
        ids = query_inputs["input_ids"]
        keep = attn if cfg.mask_ce_padding else row_valid[:, None]
        labels = torch.where(keep, ids, torch.full_like(ids, -100))
        ce = shifted_cross_entropy(stu_logits, labels, denom=global_count(labels[:, 1:] != -100))
        metrics["ce_loss"] = ce.detach()
        if cfg.only_hard_loss:
            metrics["loss"] = ce.detach()
            return ce, metrics
        loss = loss + cfg.hard_loss_weight * ce

    stu_mask = answer_region_mask(
        query_inputs["input_ids"], batch["query_x_length"], pad_token_id
    ) & row_valid[:, None]
    teacher_inputs = batch["inputs"]
    s_stu = stu_logits.shape[1]
    with torch.no_grad():
        if head_fn is not None:
            hidden = forward_fn(model_params, teacher_inputs, None, return_hidden=True)
            tea_aligned = head_fn(
                model_params,
                aligned_teacher_gather(
                    hidden, batch["in_context_length"], batch["query_x_length"], s_stu
                ),
            )
        else:
            tea_aligned = aligned_teacher_gather(
                forward_fn(model_params, teacher_inputs, None),
                batch["in_context_length"], batch["query_x_length"], s_stu,
            )
    kl = masked_kl_divergence(
        stu_logits, tea_aligned, stu_mask, temperature, cfg.kl_eps, impl=cfg.kl_impl,
        denom=global_count(stu_mask),
    )
    metrics["kl_loss"] = kl.detach()
    loss = loss + kl
    metrics["loss"] = loss.detach()
    return loss, metrics


# ---------------------------------------------------------------------------
# Schedules and optimizer
# ---------------------------------------------------------------------------


def cosine_schedule_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int):
    """``transformers.get_cosine_schedule_with_warmup``'s factor curve
    (reference icv_src/icv_module.py:203-205), in f32 as JAX computes it."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        warm = f32(max(1.0, warmup_steps))
        rest = f32(max(1.0, total_steps - warmup_steps))
        if step < warmup_steps:
            factor = step / warm
        else:
            progress = (step - f32(warmup_steps)) / rest
            factor = max(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress)))
        return float(f32(peak_lr) * f32(factor))

    return schedule


def make_lr_schedules(cfg: ICVModuleConfig, total_steps: int) -> dict:
    """Per-group schedules, keyed like the optimizer groups; the argument
    counts OPTIMIZER steps."""
    warmup = (
        int(cfg.warm_steps * total_steps)
        if isinstance(cfg.warm_steps, float) and cfg.warm_steps < 1
        else int(cfg.warm_steps)
    )
    return {
        "icv": cosine_schedule_with_warmup(cfg.icv_lr, warmup, total_steps),
        "alpha": cosine_schedule_with_warmup(cfg.alpha_lr, warmup, total_steps),
    }


class ICVOptimizer:
    """AdamW over (icv, alpha, temperature) with optax's joint clip and
    ``MultiSteps`` accumulation (see the module docstring)."""

    def __init__(
        self, encoder: GlobalICVEncoder, temperature: torch.Tensor,
        cfg: ICVModuleConfig, total_steps: int,
    ):
        self.cfg = cfg
        self.schedules = make_lr_schedules(cfg, total_steps)
        self.group_schedule = {"icv": "icv", "alpha": "alpha", "temperature": "icv"}
        self.params = {"icv": encoder.icv, "alpha": encoder.alpha, "temperature": temperature}
        self.opt = torch.optim.AdamW(
            [
                {"params": [encoder.icv], "weight_decay": cfg.weight_decay, "name": "icv"},
                {"params": [encoder.alpha], "weight_decay": cfg.weight_decay, "name": "alpha"},
                # with learnable_t the reference registers T but never adds
                # it to a group (icv_src/icv_module.py:171-209); here it
                # trains at icv_lr, with no decay toward 0
                {"params": [temperature], "weight_decay": 0.0, "name": "temperature"},
            ],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8,
        )
        self.accum = max(int(cfg.accumulate_grad_batches), 1)
        self.mini_step = 0  # micro-batches folded into ``acc`` so far
        self.count = 0  # inner optimizer steps taken (the schedules' argument)
        self.acc = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def update(self, grads: dict) -> None:
        """Fold one micro-batch's gradients (None = no gradient) into the
        running mean; on every ``accum``-th call apply the clipped mean."""
        k = self.mini_step
        with torch.no_grad():
            for name, acc in self.acc.items():
                g = grads.get(name)
                g = torch.zeros_like(acc) if g is None else g
                acc.add_((g - acc) / (k + 1))
        self.mini_step += 1
        if self.mini_step < self.accum:
            return
        with torch.no_grad():
            clip = self.cfg.gradient_clip_val
            if clip and clip > 0:
                norm = global_norm(self.acc.values())
                if not norm < clip:
                    for acc in self.acc.values():
                        acc.mul_(clip / norm)
            for group in self.opt.param_groups:
                name = group["name"]
                group["lr"] = self.schedules[self.group_schedule[name]](self.count)
                p = self.params[name]
                p.grad = self.acc[name].clone() if p.requires_grad else None
            self.opt.step()
            for p in self.params.values():
                p.grad = None
            for acc in self.acc.values():
                acc.zero_()
        self.mini_step = 0
        self.count += 1

    def state_dict(self) -> dict:
        return {
            "adamw": self.opt.state_dict(), "mini_step": self.mini_step,
            "count": self.count, "acc": {k: v.clone() for k, v in self.acc.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        self.count = int(state["count"])
        with torch.no_grad():
            for k, v in state["acc"].items():
                self.acc[k].copy_(v)


def global_norm(tensors) -> float:
    """√Σ‖t‖² over ``tensors`` in f32 (``optax.global_norm``)."""
    return float(torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors)))


# ---------------------------------------------------------------------------
# Train state + step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    encoder: GlobalICVEncoder
    temperature: torch.Tensor  # f32 scalar; requires_grad iff learnable_t
    optimizer: ICVOptimizer
    step: int = 0  # micro-batches taken

    def state_dict(self) -> dict:
        return {
            "encoder": {k: v.detach().clone() for k, v in self.encoder.state_dict().items()},
            "temperature": self.temperature.detach().clone(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.encoder.load_state_dict(state["encoder"])
        with torch.no_grad():
            self.temperature.copy_(state["temperature"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def init_train_state(
    encoder: GlobalICVEncoder, cfg: ICVModuleConfig, total_steps: int
) -> TrainState:
    temperature = torch.tensor(
        float(cfg.init_temperature), dtype=torch.float32, device=encoder.icv.device,
        requires_grad=cfg.learnable_t,
    )
    return TrainState(encoder, temperature, ICVOptimizer(encoder, temperature, cfg, total_steps))


@torch.no_grad()
def decay_temperature(state: TrainState, cfg: ICVModuleConfig) -> None:
    """Step decay, in place (reference icv_src/icv_module.py:150-158).
    ``decay_per_step`` counts OPTIMIZER steps while ``state.step`` counts
    micro-batches: with accumulation the decay fires once per optimizer-step
    boundary."""
    if cfg.decay_ratio < 0:
        return
    if cfg.decay_per_step <= 0:
        # the reference crashes here too (icv_src/icv_module.py:55-56)
        raise ValueError(
            "decay_ratio is set but decay_per_step is not: give a positive int "
            "(optimizer steps) or a float in (0,1) (fraction of total)"
        )
    accum = max(int(cfg.accumulate_grad_batches), 1)
    opt_step = state.step // accum
    dps = int(cfg.decay_per_step)
    if opt_step % dps == 0 and opt_step != 0 and state.step % accum == 0:
        t = state.temperature
        t.copy_(torch.clamp(t * cfg.decay_ratio, min=cfg.min_temperature))


def reduce_gradients(grads: dict) -> dict:
    """A rank's ``{icv, alpha, temperature}`` gradients made the global
    batch's (None stays None): ``(icv, alpha)`` summed over dp × sp (one
    part a token chunk), the temperature over dp alone (it enters after
    the hidden-state gather, so it is whole on every sp rank)."""
    return {k: None if g is None else (all_reduce_dp if k == "temperature"
                                       else all_reduce_grad)(g)
            for k, g in grads.items()}


def make_train_step(
    forward_fn: Callable,
    cfg: ICVModuleConfig,
    pad_token_id: int,
    head_fn: Optional[Callable] = None,
):
    """``step(state, model_params, batch) -> metrics``: one micro-batch,
    updating ``state`` in place (JAX ``make_train_step``)."""

    def step(state: TrainState, model_params, batch) -> dict:
        decay_temperature(state, cfg)
        enc = state.encoder
        loss, metrics = icv_loss_fn(
            enc, state.temperature, model_params, batch, forward_fn, cfg, pad_token_id,
            head_fn,
        )
        trainable = {"icv": enc.icv, "alpha": enc.alpha, "temperature": state.temperature}
        wrt = {k: p for k, p in trainable.items() if p.requires_grad}
        grads = dict(zip(wrt, torch.autograd.grad(loss, list(wrt.values()), allow_unused=True)))
        if dp_size() > 1 or sp_size() > 1:  # each rank's loss is its share of the global one
            grads = reduce_gradients(grads)
            for key in ("loss", "kl_loss", "ce_loss"):
                if key in metrics:
                    metrics[key] = all_reduce_dp(metrics[key])
        opt_step = state.step // max(int(cfg.accumulate_grad_batches), 1)
        saved_t = state.temperature.detach().clone()
        state.optimizer.update(grads)
        if cfg.decay_ratio >= 0:
            with torch.no_grad():  # a decaying T is not also trained
                state.temperature.copy_(saved_t)
        state.step += 1
        metrics["temperature"] = state.temperature.detach().clone()
        metrics["grad_norm"] = global_norm(g for g in grads.values() if g is not None)
        for name, sched in state.optimizer.schedules.items():
            metrics[f"lr-{name}"] = sched(opt_step)
        if cfg.log_alpha:  # reference icv_src/icv_module.py:164-167
            alpha = enc.get_alpha().detach()
            for i in range(alpha.shape[0]):
                metrics[f"alpha/alpha-{i}"] = alpha[i]
        return metrics

    return step
