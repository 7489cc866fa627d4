"""The training loop: an eager train step per rank, the epochs
(counterpart of ``licv_vqa_tpu/train/trainer.py``).

Kept from JAX: epochs, ``limit_train_batches``, gradient accumulation, step
checkpoints every ``checkpoint_every_n_steps`` micro-batches with resume
(seed+epoch fast-forward through the batches already trained, or the
loader's own iterator state where it has one), the preemption save, the
metrics hook, a ``torch.profiler`` trace of ``profile_steps`` steps, and
the final ``icv_cpk.pth``.

The mesh (``strategy=dp|dp_tp|dp_sp|dp_tp_sp``, ``tp``, ``sp``,
``devices``): one process per rank (``python -m torch.distributed.run``),
JAX's single-process semantics.  Every rank builds the same seed-ordered
global batch from its loader (the threaded one or grain's, both unsharded),
zero-pads it to a dp multiple (``_pad_batch_to_multiple``: padded rows are
inert in both losses), right-pads its token and mask leaves to an sp
multiple (``_pad_seq_to_multiple``, after the dp padding as JAX's order
is) and takes its contiguous dp rows whole; under ``dp_tp*`` the frozen
weights are this rank's Megatron shards, and under ``*sp`` the train
forwards take the rank's chunk of the sequence and run ring attention
(``parallel/ring.py``).  The loss and the gradients are the global
batch's (``icv/module.py``), so every rank holds the same ``(icv, alpha)``;
rank 0 alone writes the step checkpoints, the metrics, the profile and the
artifact.  The preemption flag is the global OR over the ranks every
``preempt_sync_every_n_steps`` micro-steps.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.distributed import PreemptionGuard, is_main_process, sync_should_stop
from ..core.mesh import Mesh, MeshConfig, create_mesh, using_mesh
from ..icv.encoder import GlobalICVEncoder
from ..icv.module import ICVModuleConfig, TrainState, init_train_state, make_train_step
from ..parallel.sharding import dp_row_slice
from ..utils.log import get_logger
from ..utils.profiling import StepTimer, trace
from .checkpoint import StepCheckpointer, save_icv_checkpoint

logger = get_logger("train")

STRATEGIES = ("dp", "dp_tp", "dp_sp", "dp_tp_sp")


def _pad_batch_to_multiple(batch, multiple: int):
    """Zero-pad every leaf's batch dim to a dp multiple (JAX
    ``_pad_batch_to_multiple``, train/trainer.py:40-58): the padded rows
    have an all-zero attention mask, which both losses leave out."""
    if isinstance(batch, dict):
        return {k: _pad_batch_to_multiple(v, multiple) for k, v in batch.items()}
    x = np.asarray(batch)
    rem = (-x.shape[0]) % multiple
    if multiple <= 1 or rem == 0:
        return x
    return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))


def _is_seq_leaf(key: str, x) -> bool:
    """A (B, S) token or mask leaf (JAX ``_is_seq_leaf``,
    train/trainer.py:74-79)."""
    return key in ("input_ids", "attention_mask") and getattr(x, "ndim", 0) == 2


def _pad_seq_to_multiple(batch, sp: int, pad_token_id: int, _key: str = ""):
    """Right-pad every (B, S) token and mask leaf (of ``inputs`` and
    ``query_inputs`` alike, each to its own length) to an sp multiple, the
    ids with ``pad_token_id`` and the masks with 0 (JAX
    ``_pad_seq_to_multiple``, train/trainer.py:82-103): loss-neutral, the
    answer mask leaves pad ids out and attention mask-0 keys."""
    if isinstance(batch, dict):
        return {k: _pad_seq_to_multiple(v, sp, pad_token_id, k) for k, v in batch.items()}
    if sp <= 1 or not _is_seq_leaf(_key, batch):
        return batch
    x = np.asarray(batch)
    rem = (-x.shape[1]) % sp
    if rem == 0:
        return x
    fill = pad_token_id if _key == "input_ids" else 0
    return np.pad(x, [(0, 0), (0, rem)], constant_values=fill)


def _take_rows(batch, rows: slice):
    if isinstance(batch, dict):
        return {k: _take_rows(v, rows) for k, v in batch.items()}
    return batch[rows]


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
    # how often (in micro-steps) the ranks OR their preemption flags: the
    # sync is a collective, so its cadence is a function of the step alone
    # (JAX train/trainer.py:122-128); one process checks every step
    preempt_sync_every_n_steps: int = 8
    profile_steps: int = 0  # >0: torch.profiler trace of steps [2, 2+N)

    @classmethod
    def from_config(cls, cfg) -> "TrainerConfig":
        """The keys this trainer reads; the others (``precision``,
        ``remat``, ``default_root_dir``, ...) change nothing here."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: cfg[k] for k in cfg.keys() if k in known})

    def check_strategy(self) -> None:
        if self.strategy not in STRATEGIES:
            raise ValueError(f"trainer.strategy must be one of {STRATEGIES}, got {self.strategy!r}")

    def mesh_config(self, world_size: int) -> MeshConfig:
        """dp x tp x sp over the launcher's ranks: ``devices`` -1 (or 0)
        takes the world size, any other count must equal it; ``tp`` counts
        under a strategy with tp, ``sp`` under one with sp (JAX
        train/trainer.py:176-192), and they must divide the world."""
        if self.devices not in (-1, 0) and self.devices != world_size:
            raise ValueError(
                f"trainer.devices={self.devices} but the launcher started {world_size} "
                "process(es): one process per device (python -m torch.distributed.run "
                f"--nproc_per_node={self.devices})")
        tp = self.tp if "tp" in self.strategy else 1
        sp = self.sp if "sp" in self.strategy else 1
        return MeshConfig(dp=-1, tp=tp, sp=sp)


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
        mesh: Optional[Mesh] = None,
    ):
        """``mesh``: the caller's (``core.mesh.create_mesh``), whose
        ``model_params`` are already this rank's shards
        (``models/registry.py``); None is one process, which ``trainer_cfg``
        must then ask for (and a launched world of more ranks raises)."""
        trainer_cfg.check_strategy()
        if mesh is None:
            mesh = create_mesh(trainer_cfg.mesh_config(1), world_size=1, rank=0)
        self.mesh = mesh
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
        """Train over ``loader``; the trainer's mesh is the current one
        (``core.mesh.using_mesh``) while it runs."""
        with using_mesh(self.mesh):
            return self._fit(loader, Path(run_dir), lmm_args, use_sigmoid)

    def _fit(self, loader, run_dir: Path, lmm_args: Optional[dict],
             use_sigmoid: bool) -> TrainState:
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
        main = is_main_process()
        dp = self.mesh.dp
        sync_every = max(1, cfg.preempt_sync_every_n_steps) if self.mesh.world_size > 1 else 1

        def loader_snapshot():
            return loader.get_state() if hasattr(loader, "get_state") else None

        def save(step, loader_state):  # one writer: the state is the same on every rank
            if main:
                ckpt.save(step, state.state_dict(), loader_state=loader_state)

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
                    # iterator state replays exactly the untrained rest;
                    # every rank ORs the flags on the same steps
                    if micro_step % sync_every == 0 and sync_should_stop(guard.should_stop):
                        logger.warning("preemption requested — checkpointing at micro %d", micro_step)
                        ffwd = not restored_loader and epoch == epoch_start and (bi + 1) < offset
                        save(micro_step, None if ffwd else loader_snapshot())
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
                    if cfg.profile_steps > 0 and micro_step == 2 and main:
                        profiler_ctx = trace(run_dir / "profile")
                        profiler_ctx.__enter__()
                    batch = _pad_batch_to_multiple(batch, dp)
                    batch = _pad_seq_to_multiple(batch, self.mesh.sp, self.pad_token_id)
                    batch = _take_rows(batch, dp_row_slice(len(batch["query_x_length"])))
                    metrics = step_fn(state, self.model_params, batch_to_device(batch, self.device))
                    micro_step = state.step
                    timer.tick()
                    if profiler_ctx is not None and micro_step >= 2 + cfg.profile_steps:
                        profiler_ctx.__exit__(None, None, None)
                        profiler_ctx = None
                        logger.info("profiler trace written to %s", run_dir / "profile")
                    if micro_step % max(1, cfg.log_every_n_steps) == 0 and main:
                        self._log(metrics, timer, epoch, micro_step, total_micro,
                                  (micro_step - start_micro) / max(time.time() - t0, 1e-6))
                    if cfg.checkpoint_every_n_steps > 0 and micro_step % cfg.checkpoint_every_n_steps == 0:
                        save(micro_step, loader_snapshot())
        finally:
            if profiler_ctx is not None:
                profiler_ctx.__exit__(None, None, None)
            guard.close()

        # the final artifact with the reference's key contract, rank 0 only
        # (reference @rank_zero_only postprocess, train.py:88)
        if main:
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
