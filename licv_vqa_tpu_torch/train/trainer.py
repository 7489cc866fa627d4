"""The training loop: one device, an eager train step, the epochs
(counterpart of ``licv_vqa_tpu/train/trainer.py``).

Kept from JAX: epochs, ``limit_train_batches``, gradient accumulation, step
checkpoints every ``checkpoint_every_n_steps`` micro-batches with resume
(seed+epoch fast-forward through the batches already trained, or the
loader's own iterator state where it has one), the preemption save, the
metrics hook, a ``torch.profiler`` trace of ``profile_steps`` steps, and
the final ``icv_cpk.pth``.  Not ported: the mesh (dp/tp/sp), multi-host and
the grain loader (ROADMAP.md Queue 1 item 16); asking for them raises.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.distributed import PreemptionGuard, is_main_process
from ..icv.encoder import GlobalICVEncoder
from ..icv.module import ICVModuleConfig, TrainState, init_train_state, make_train_step
from ..utils.log import get_logger
from ..utils.profiling import StepTimer, trace
from .checkpoint import StepCheckpointer, save_icv_checkpoint

logger = get_logger("train")

_NOT_PORTED = "is not ported to licv_vqa_tpu_torch yet (ROADMAP.md Queue 1 item 16)"


@dataclasses.dataclass
class TrainerConfig:
    """Mirror of config/trainer/*.yaml (reference override keys kept)."""

    devices: int = -1
    strategy: str = "dp"
    tp: int = 1
    sp: int = 1
    max_epochs: int = 10
    gradient_clip_val: float = 1.0
    log_every_n_steps: int = 10
    accumulate_grad_batches: int = 1
    checkpoint_every_n_steps: int = 200
    limit_train_batches: int = -1
    profile_steps: int = 0  # >0: torch.profiler trace of steps [2, 2+N)

    @classmethod
    def from_config(cls, cfg) -> "TrainerConfig":
        """The keys this trainer reads; the others (``precision``,
        ``remat``, ``default_root_dir``, ...) change nothing here."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: cfg[k] for k in cfg.keys() if k in known})

    def check_ported(self) -> None:
        if self.strategy != "dp" or self.tp != 1 or self.sp != 1:
            raise NotImplementedError(f"trainer.strategy={self.strategy} (tp/sp) {_NOT_PORTED}")
        if self.devices not in (-1, 0, 1):
            raise NotImplementedError(f"trainer.devices={self.devices} (data parallel) {_NOT_PORTED}")


def batch_to_device(batch, device):
    """Nested dict of numpy arrays → the same nesting of tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device, non_blocking=True)


class Trainer:
    def __init__(
        self,
        trainer_cfg: TrainerConfig,
        module_cfg: ICVModuleConfig,
        encoder: GlobalICVEncoder,
        forward_fn: Callable,  # (model_params, inputs, icv_scaled, **kw) -> logits
        model_params: Any,
        pad_token_id: int,
        metrics_hook: Optional[Callable[[int, dict], None]] = None,
        head_fn: Optional[Callable] = None,  # gather-before-head teacher path
    ):
        trainer_cfg.check_ported()
        self.cfg = trainer_cfg
        self.module_cfg = dataclasses.replace(
            module_cfg,
            gradient_clip_val=trainer_cfg.gradient_clip_val,
            accumulate_grad_batches=trainer_cfg.accumulate_grad_batches,
        )
        self.encoder = encoder
        self.forward_fn = forward_fn
        self.model_params = model_params
        self.pad_token_id = pad_token_id
        self.metrics_hook = metrics_hook
        self.head_fn = head_fn
        self.device = encoder.icv.device

    def fit(
        self,
        loader,
        run_dir: str | Path,
        lmm_args: Optional[dict] = None,
        use_sigmoid: bool = False,
    ) -> TrainState:
        cfg = self.cfg
        steps_per_epoch = len(loader)
        if cfg.limit_train_batches and cfg.limit_train_batches > 0:
            steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
        total_micro = steps_per_epoch * cfg.max_epochs
        total_steps = max(1, total_micro // cfg.accumulate_grad_batches)

        # a fractional decay_per_step is a fraction of the total optimizer
        # steps (reference icv_src/icv_module.py:54-68)
        mcfg = self.module_cfg
        if 0 < mcfg.decay_per_step < 1:
            mcfg = dataclasses.replace(
                mcfg, decay_per_step=max(1, int(total_steps * mcfg.decay_per_step))
            )
            self.module_cfg = mcfg

        state = init_train_state(self.encoder, mcfg, total_steps)
        run_dir = Path(run_dir)
        ckpt = StepCheckpointer(run_dir / "steps")
        resume_step, saved = ckpt.restore(map_location=self.device)
        restored_loader = False
        if resume_step is not None:
            state.load_state_dict(saved)
            logger.info("resumed from step checkpoint %d", resume_step)
            # only a MID-epoch checkpoint's iterator state is replayed: one
            # saved at an epoch boundary is exhausted
            mid_epoch = steps_per_epoch and resume_step % steps_per_epoch != 0
            loader_state = ckpt.restore_loader_state(resume_step) if mid_epoch else None
            if loader_state is not None and hasattr(loader, "set_state"):
                loader.set_state(loader_state)
                restored_loader = True

        step_fn = make_train_step(self.forward_fn, mcfg, self.pad_token_id, self.head_fn)

        def loader_snapshot():
            return loader.get_state() if hasattr(loader, "get_state") else None

        micro_step = state.step
        start_micro = micro_step
        done = False
        t0 = time.time()
        timer = StepTimer()
        profiler_ctx = None
        guard = PreemptionGuard()
        # deterministic resume: the per-epoch shuffle is seeded seed+epoch,
        # so the batches already trained fast-forward
        epoch_start = micro_step // steps_per_epoch if steps_per_epoch else 0
        skip_batches = micro_step % steps_per_epoch if steps_per_epoch else 0
        if not restored_loader and epoch_start and hasattr(loader, "epoch"):
            loader.epoch = epoch_start
        try:
            for epoch in range(min(epoch_start, cfg.max_epochs), cfg.max_epochs):
                if done:
                    break
                offset = skip_batches if epoch == epoch_start else 0
                limit = steps_per_epoch - (offset if restored_loader else 0)
                batch_iter = iter(loader)
                bi = -1
                while True:
                    # checked BEFORE the next batch is pulled, so a saved
                    # iterator state replays exactly the untrained rest
                    if guard.should_stop:
                        logger.warning("preemption requested — checkpointing at micro %d", micro_step)
                        ffwd = not restored_loader and epoch == epoch_start and (bi + 1) < offset
                        ckpt.save(
                            micro_step, state.state_dict(),
                            loader_state=None if ffwd else loader_snapshot(),
                        )
                        done = True
                        break
                    if micro_step >= total_micro:
                        done = True
                        break
                    try:
                        batch = next(batch_iter)
                    except StopIteration:
                        break
                    bi += 1
                    if bi >= limit:
                        break
                    if not restored_loader and epoch == epoch_start and bi < offset:
                        continue  # fast-forward through batches already trained
                    if cfg.profile_steps > 0 and micro_step == 2:
                        profiler_ctx = trace(run_dir / "profile")
                        profiler_ctx.__enter__()
                    metrics = step_fn(state, self.model_params, batch_to_device(batch, self.device))
                    micro_step = state.step
                    timer.tick()
                    if profiler_ctx is not None and micro_step >= 2 + cfg.profile_steps:
                        profiler_ctx.__exit__(None, None, None)
                        profiler_ctx = None
                        logger.info("profiler trace written to %s", run_dir / "profile")
                    if micro_step % max(1, cfg.log_every_n_steps) == 0:
                        self._log(metrics, timer, epoch, micro_step, total_micro,
                                  (micro_step - start_micro) / max(time.time() - t0, 1e-6))
                    if cfg.checkpoint_every_n_steps > 0 and micro_step % cfg.checkpoint_every_n_steps == 0:
                        ckpt.save(micro_step, state.state_dict(), loader_state=loader_snapshot())
        finally:
            if profiler_ctx is not None:
                profiler_ctx.__exit__(None, None, None)
            guard.close()

        # the final artifact with the reference's key contract, rank 0 only
        # (reference @rank_zero_only postprocess, train.py:88)
        if is_main_process():
            save_icv_checkpoint(
                run_dir, state.encoder.icv, state.encoder.alpha, use_sigmoid=use_sigmoid,
                lmm_args=lmm_args or {}, temperature=float(state.temperature),
            )
            logger.info("saved %s", run_dir / "icv_cpk.pth")
        return state

    def _log(self, metrics, timer, epoch, micro_step, total_micro, rate) -> None:
        m = {k: float(v) for k, v in metrics.items()}
        if not np.isfinite(m.get("loss", 0.0)):
            logger.error(
                "non-finite loss at micro %d: %s — check data/lr", micro_step,
                {k: v for k, v in m.items() if "loss" in k},
            )
        m.update(timer.stats)
        logger.info(
            "epoch %d micro %d/%d loss=%.4f kl=%.4f (%.2f it/s)", epoch, micro_step,
            total_micro, m.get("loss", float("nan")), m.get("kl_loss", float("nan")), rate,
        )
        if self.metrics_hook:
            self.metrics_hook(micro_step, m)
