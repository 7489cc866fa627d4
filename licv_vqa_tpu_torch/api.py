"""High-level factories shared by the CLIs (reference: utils.py:31-133)."""

from __future__ import annotations

from typing import Optional

from .data.datasets import CaptionDataset, VQADataset
from .data.loaders import load_coco_ds, load_okvqa_ds, load_vqav2_ds
from .data.prompt import PromptManager
from .metrics.postprocess import caption_postprocess, ok_vq_postprocess, vqa_postprocess
from .utils.paths import get_icv_cpk_path, get_inference_paths  # re-export


def init_prompt_manager(cfg) -> PromptManager:
    return PromptManager(
        prompt_template=cfg.prompt.prompt_template,
        column_token_map=cfg.prompt.column_token_map.to_dict(),
        label_field=cfg.prompt.label_filed,  # reference key spelling
        sep_token=cfg.prompt.sep_token,
        query_prompt_template=cfg.prompt.get("query_prompt_template"),
    )


def init_dataset(cfg, split: Optional[str]):
    """Raw eval dataset + postprocess fn (reference: utils.py:83-112)."""
    d = cfg.data_cfg.task.datasets
    if d.name == "vqav2":
        ds = load_vqav2_ds(
            d.root_dir,
            d.train_coco_dataset_root,
            d.val_coco_dataset_root,
            split,
            val_ann_file=d.get("val_ann_file"),
        )
        return ds, vqa_postprocess
    if d.name == "okvqa":
        ds = load_okvqa_ds(
            d.root_dir, d.train_coco_dataset_root, d.val_coco_dataset_root, split
        )
        return ds, ok_vq_postprocess
    if d.name == "coco2017":
        ds = load_coco_ds(
            train_coco_dataset_root=d.train_coco_dataset_root,
            val_coco_dataset_root=d.val_coco_dataset_root,
            train_coco_annotation_file=d.train_coco_annotation_file,
            val_coco_annotation_file=d.val_coco_annotation_file,
            split=split,
        )
        return ds, caption_postprocess
    raise ValueError(f"unknown dataset {d.name!r}")


def init_train_dataset(cfg, prompt_manager: PromptManager, seed: Optional[int] = None):
    """Few-shot training dataset (reference: icv_datamodule.py:29-61)."""
    task = cfg.data_cfg.task
    d = task.datasets
    if task.task_name == "vqa":
        return VQADataset(
            name=d.name,
            root_dir=d.root_dir,
            train_coco_dataset_root=d.train_coco_dataset_root,
            val_coco_dataset_root=d.val_coco_dataset_root,
            prompt_manager=prompt_manager,
            instruction=task.instruction,
            few_shot_num=d.few_shot_num,
            max_train_size=d.max_train_size,
            split="train",
            val_ann_file=d.get("val_ann_file"),
            filter_ques_type=d.get("filter_ques_type"),
            select_from_query=d.get("select_from_query", True),
            seed=seed,
        )
    if task.task_name == "caption":
        return CaptionDataset(
            name=d.name,
            train_coco_dataset_root=d.train_coco_dataset_root,
            val_coco_dataset_root=d.val_coco_dataset_root,
            train_coco_annotation_file=d.train_coco_annotation_file,
            val_coco_annotation_file=d.val_coco_annotation_file,
            prompt_manager=prompt_manager,
            instruction=task.instruction,
            few_shot_num=d.few_shot_num,
            max_train_size=d.max_train_size,
            split="train",
            select_from_query=d.get("select_from_query", True),
            seed=seed,
        )
    raise ValueError(f"unknown task {task.task_name!r}")
