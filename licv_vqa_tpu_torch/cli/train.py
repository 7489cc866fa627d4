"""ICV training CLI of the port (counterpart of ``train.py``).

Same contract as the JAX CLI: ``key=val`` overrides against
``config/train.yaml``; the run directory
``result_dir/model_cpk/<dataset>/<model>/<run_name>``; an existing
``icv_cpk.pth`` (or the reference's ``icv_cpk.bin``) there exits early;
``metrics.jsonl`` and the final ``icv_cpk.pth`` are written there, step
checkpoints under ``steps/``.

``device`` selects the torch device as in the inference CLI: ``cuda`` by
default (the shared config's ``tpu``/``gpu`` mean the accelerator), ``cpu``
for tests.  ``trainer.strategy=dp|dp_tp|dp_sp|dp_tp_sp`` (with
``trainer.tp``, ``trainer.sp`` and ``trainer.devices``) runs one process per
rank under ``python -m torch.distributed.run``: each rank computes on
``cuda:LOCAL_RANK`` (or the CPU), over ``nccl`` (``gloo`` on the CPU), and
rank 0 writes the artifacts.  ``data_cfg.loader=grain`` reads through
``train/grain_loader.py`` (as ``train.py`` does), unsharded on every rank:
each rank builds the one global batch and takes its rows.

Examples:
    python train_torch.py run_name=vqav2_idefics9b icv_module.icv_lr=1e-3
    python train_torch.py lmm=tiny-idefics trainer=debug data_cfg.bs=2 device=cpu
    python -m torch.distributed.run --standalone --nproc_per_node=2 train_torch.py \
        trainer.strategy=dp_tp trainer.tp=2
    python -m torch.distributed.run --standalone --nproc_per_node=2 train_torch.py \
        trainer.strategy=dp_sp trainer.sp=2
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..api import init_prompt_manager, init_train_dataset
from ..core.distributed import maybe_initialize_distributed, shutdown_distributed
from ..core.mesh import create_mesh
from ..data.collator import collate_icv_batch
from ..icv.encoder import GlobalICVEncoder
from ..icv.module import ICVModuleConfig
from ..models.registry import build_model
from ..train.loader import DataLoader
from ..train.trainer import Trainer, TrainerConfig
from ..utils import compose, get_icv_cpk_path, get_logger
from .inference import resolve_device

logger = get_logger("train_torch_cli")


def main(argv: list[str] | None = None) -> Path:
    cfg = compose("config", "train", list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(cfg.get("device"))
    seed = int(cfg.seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    model_name = str(cfg.lmm.name).split("/")[-1]
    save_path = get_icv_cpk_path(
        result_dir=cfg.result_dir, model_name=model_name,
        dataset_name=cfg.data_cfg.task.datasets.name, run_name=cfg.run_name,
    )
    # the reference checks icv_cpk.bin but writes icv_cpk.pth: both count
    for marker in ("icv_cpk.pth", "icv_cpk.bin"):
        if (save_path / marker).exists():
            logger.info("%s exists — exiting", save_path / marker)
            return save_path
    loader_kind = str(cfg.data_cfg.get("loader", "threads"))
    if loader_kind not in ("threads", "grain"):
        raise ValueError(f"data_cfg.loader must be threads or grain, got {loader_kind!r}")
    trainer_cfg = TrainerConfig.from_config(cfg.trainer)
    trainer_cfg.check_strategy()
    if cfg.get("wandb", False):
        logger.warning("wandb is not wired in the port — metrics.jsonl only")
    launched = maybe_initialize_distributed(device.type)
    try:
        return _train(cfg, launched or device, trainer_cfg, save_path, seed)
    finally:
        if launched is not None:
            shutdown_distributed()


def _train(cfg, device, trainer_cfg, save_path: Path, seed: int) -> Path:
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = create_mesh(trainer_cfg.mesh_config(world))
    bundle = build_model(cfg, device=device, mesh=mesh)
    prompt_manager = init_prompt_manager(cfg)
    train_ds = init_train_dataset(cfg, prompt_manager, seed=seed)
    bundle.processor.padding_side = "right"  # reference icv_datamodule.py:22
    collate = functools.partial(collate_icv_batch, processor=bundle.processor)
    if str(cfg.data_cfg.get("loader", "threads")) == "grain":
        from ..train.grain_loader import GrainDataLoader

        loader = GrainDataLoader(
            train_ds,
            batch_size=int(cfg.data_cfg.bs),
            collate_fn=collate,
            shuffle=True,
            seed=seed,
            num_workers=int(cfg.data_cfg.num_workers),
            num_epochs=1,  # the Trainer drives epochs by re-iterating
            # one global batch a step on every rank, split by the trainer:
            # JAX's single-process order
            shard_index=0,
            shard_count=1,
        )
    else:
        loader = DataLoader(
            train_ds,
            batch_size=int(cfg.data_cfg.bs),
            collate_fn=collate,
            shuffle=True,
            seed=seed,
            num_workers=int(cfg.data_cfg.num_workers),
        )

    enc_cfg = cfg.icv_module.icv_encoder
    use_sigmoid = bool(enc_cfg.get("use_sigmoid", False))
    encoder = GlobalICVEncoder(
        lmm_hidden_dim=bundle.hidden_size,
        lmm_layers=bundle.n_layers,
        alpha_learnable=bool(enc_cfg.get("alpha_learnable", True)),
        alpha_init_value=float(enc_cfg.get("alpha_init_value", 0.0)),
        use_sigmoid=use_sigmoid,
        generator=torch.Generator().manual_seed(0),
        device=device,
    )

    save_path.mkdir(parents=True, exist_ok=True)
    metrics_path = save_path / "metrics.jsonl"

    def metrics_hook(step: int, m: dict) -> None:
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"step": step, "time": time.time(), **m}) + "\n")

    trainer = Trainer(
        trainer_cfg,
        ICVModuleConfig.from_config(cfg.icv_module, cfg.trainer),
        encoder,
        bundle.train_forward,
        bundle.params,
        pad_token_id=bundle.pad_token_id,
        metrics_hook=metrics_hook,
        head_fn=bundle.head_fn,
        mesh=mesh,
    )
    trainer.fit(loader, run_dir=save_path, lmm_args=cfg.lmm.to_dict(), use_sigmoid=use_sigmoid)
    logger.info("training complete: %s", save_path)
    return save_path
