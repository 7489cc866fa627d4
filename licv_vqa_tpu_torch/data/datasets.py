"""Few-shot training datasets with the reference's shot-sampling semantics.

Reference behavior (icv_src/icv_datasets/vqa_dataset.py:75-129,
caption_dataset.py:58-97): draw ``few_shot_num`` shot indices WITH
replacement; rejection-resample the WHOLE draw while the query's global
``idx`` appears among the shots; optional question-type filter; subsample to
``max_train_size`` without replacement; ``select_from_query`` picks the shot
pool (query subset vs full set).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import get_logger
from .loaders import Table, load_okvqa_ds, load_vqav2_ds, load_coco_ds
from .prompt import PromptManager

logger = get_logger("data")


class _FewShotDataset:
    def __init__(
        self,
        query_ds: Table,
        select_ds: Table,
        prompt_manager: PromptManager,
        instruction: str,
        few_shot_num: int,
        seed: Optional[int] = None,
    ):
        self.query_ds = query_ds
        self.select_ds = select_ds
        self.prompt_manager = prompt_manager
        self.instruction = instruction
        self.few_shot_num = few_shot_num
        self._base_seed = 0 if seed is None else int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Fresh shot draws each epoch (the loaders call this per epoch)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.query_ds)

    def _sample_shots(self, query_idx_global, index: int) -> list[int]:
        # A fresh generator per (seed, epoch, query index): draws are a pure
        # function of those three, NOT of call order — loader worker threads
        # and grain mp workers would otherwise race a shared Generator
        # (non-thread-safe, and nondeterministic under interleaving), which
        # breaks the trainer's seed-determined resume fast-forward.
        rng = np.random.default_rng(
            np.random.SeedSequence((self._base_seed, self._epoch, int(index)))
        )
        while True:
            shots = rng.integers(
                0, len(self.select_ds), size=self.few_shot_num
            ).tolist()
            if query_idx_global not in {self.select_ds.raw(i)["idx"] for i in shots}:
                return shots

    def __getitem__(self, index: int) -> dict:
        query = self.query_ds[index]
        shot_ids = self._sample_shots(query["idx"], index)
        ice_prompt: list = [self.instruction] if self.instruction else []
        for i in shot_ids:
            shot = self.select_ds[i]
            ice_prompt += [
                shot["image"],
                self.prompt_manager.gen_ice_text_with_label(shot, add_sep_token=True),
            ]
        query_prompt = [
            query["image"],
            self.prompt_manager.gen_ice_text_with_label(query, add_sep_token=False),
        ]
        query_x = [
            query["image"],
            self.prompt_manager.gen_query_text_without_label(query),
        ]
        return {
            "ice_prompt": ice_prompt,
            "query_prompt": query_prompt,
            "query_x": query_x,
        }


def _subsample(ds: Table, max_train_size: int, rng) -> Table:
    if max_train_size > 0 and len(ds) > max_train_size:
        idx = rng.choice(len(ds), size=max_train_size, replace=False)
        return ds.select(idx.tolist())
    return ds


class VQADataset(_FewShotDataset):
    def __init__(
        self,
        name: str,
        root_dir: str,
        train_coco_dataset_root: str,
        val_coco_dataset_root: str,
        prompt_manager: PromptManager,
        instruction: str = "",
        few_shot_num: int = 8,
        max_train_size: int = 10000,
        split: str = "train",
        val_ann_file: Optional[str] = None,
        filter_ques_type: Optional[str] = None,
        select_from_query: bool = True,
        seed: Optional[int] = None,
        ds: Optional[Table] = None,  # injection point for synthetic fixtures
    ):
        if ds is None:
            if name == "vqav2":
                ds = load_vqav2_ds(
                    root_dir,
                    train_coco_dataset_root,
                    val_coco_dataset_root,
                    split=split,
                    val_ann_file=val_ann_file,
                )
            elif name == "okvqa":
                ds = load_okvqa_ds(
                    root_dir,
                    train_coco_dataset_root,
                    val_coco_dataset_root,
                    split=split,
                )
            else:
                raise ValueError(f"Dataset {name} not supported")
        rng = np.random.default_rng(seed)
        query_ds = ds
        if filter_ques_type:
            query_ds = query_ds.filter(
                lambda r: r["gen_question_type"] == filter_ques_type
            )
            logger.info("After question-type filter: %d rows", len(query_ds))
        query_ds = _subsample(query_ds, max_train_size, rng)
        select_ds = query_ds if select_from_query else ds
        logger.info(
            "Query dataset size: %d, Select dataset size: %d",
            len(query_ds),
            len(select_ds),
        )
        super().__init__(
            query_ds, select_ds, prompt_manager, instruction, few_shot_num, seed
        )


class CaptionDataset(_FewShotDataset):
    def __init__(
        self,
        name: str,
        train_coco_dataset_root: str,
        val_coco_dataset_root: str,
        train_coco_annotation_file: str,
        val_coco_annotation_file: str,
        prompt_manager: PromptManager,
        instruction: str = "",
        few_shot_num: int = 8,
        max_train_size: int = 10000,
        split: str = "train",
        select_from_query: bool = True,
        seed: Optional[int] = None,
        ds: Optional[Table] = None,
    ):
        del name
        if ds is None:
            ds = load_coco_ds(
                train_coco_dataset_root,
                val_coco_dataset_root,
                train_coco_annotation_file,
                val_coco_annotation_file,
                split=split,
            )
        rng = np.random.default_rng(seed)
        query_ds = _subsample(ds, max_train_size, rng)
        select_ds = query_ds if select_from_query else ds
        super().__init__(
            query_ds, select_ds, prompt_manager, instruction, few_shot_num, seed
        )
