"""Raw dataset loaders: VQAv2, OK-VQA, COCO captions.

Same join/emit semantics as the reference loaders (reference:
icv_src/icv_datasets/load_ds_utils.py) on a dependency-free ``Table``
(plain rows + lazy PIL image decode) instead of HF ``datasets``:

- VQAv2: join questions→annotations on ``question_id``, sort by question_id,
  ``answer`` = ``multiple_choice_answer``, ``gen_question_type`` = first word
  of ``question_type``; optional ``val_ann_file`` override for the val subset
  (reference :19-22,53-91).
- OK-VQA: same join; ``answer = answers[0]["answer"]``; ``gen_question_type``
  = ``question_type`` verbatim (reference :150-178).
- COCO2017 captions: ``{single_caption, captions, image, image_id, idx}``
  sorted by image_id (reference :190-224, coco_dataset.py:24-35).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence


class Table:
    """Minimal dataset: list of row dicts, lazy image decode on access."""

    def __init__(self, rows: list[dict], decode_images: bool = True):
        self.rows = rows
        self.decode_images = decode_images

    def __len__(self) -> int:
        return len(self.rows)

    def _materialize(self, row: dict) -> dict:
        if not self.decode_images:
            return row
        img = row.get("image")
        if isinstance(img, (str, Path)):
            from .processor import ImageRef

            row = dict(row)
            # lazy handle: decoded+resized exactly once by the processor's
            # LRU, no matter how many prompt views reference the image
            row["image"] = ImageRef(str(img))
        return row

    def __getitem__(self, idx):
        if isinstance(idx, (list, tuple)):
            cols: dict[str, list] = {}
            for i in idx:
                for k, v in self.rows[int(i)].items():
                    cols.setdefault(k, []).append(v)
            return cols
        return self._materialize(self.rows[int(idx)])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def raw(self, idx: int) -> dict:
        return self.rows[int(idx)]

    def select(self, indices: Iterable[int]) -> "Table":
        return Table([self.rows[int(i)] for i in indices], self.decode_images)

    def filter(self, fn: Callable[[dict], bool]) -> "Table":
        return Table([r for r in self.rows if fn(r)], self.decode_images)

    def sort(self, key: str) -> "Table":
        return Table(sorted(self.rows, key=lambda r: r[key]), self.decode_images)

    def column(self, key: str) -> list:
        return [r[key] for r in self.rows]


def _coco_image_path(root: str | Path, split2014: str, image_id: int) -> str:
    return str(Path(root) / f"COCO_{split2014}_{image_id:012d}.jpg")


def _load_json(path: str | Path):
    with open(path) as f:
        return json.load(f)


def _join_vqa_split(
    ques_file: Path,
    ann_file: Path,
    coco_root: str,
    split2014: str,
    answer_fn: Callable[[dict], str],
    qtype_fn: Callable[[str], str],
) -> Table:
    questions = {q["question_id"]: q for q in _load_json(ques_file)["questions"]}
    rows = []
    for ann in _load_json(ann_file)["annotations"]:
        q = questions[ann["question_id"]]
        rows.append(
            {
                "question_id": ann["question_id"],
                "question": q["question"],
                "image_id": ann["image_id"],
                "image": _coco_image_path(coco_root, split2014, ann["image_id"]),
                "answer": answer_fn(ann),
                "answers": ann.get("answers", []),
                "question_type": ann.get("question_type", ""),
                "answer_type": ann.get("answer_type", ""),
                "gen_question_type": qtype_fn(ann.get("question_type", "")),
            }
        )
    rows.sort(key=lambda r: r["question_id"])
    for i, r in enumerate(rows):
        r["idx"] = i
    return Table(rows)


def load_vqav2_ds(
    root_dir: str,
    train_coco_dataset_root: str,
    val_coco_dataset_root: str,
    split: Optional[str] = None,
    val_ann_file: Optional[str] = None,
):
    root = Path(root_dir)

    def train():
        return _join_vqa_split(
            root / "v2_OpenEnded_mscoco_train2014_questions.json",
            root / "v2_mscoco_train2014_annotations.json",
            train_coco_dataset_root,
            "train2014",
            lambda a: a["multiple_choice_answer"],
            lambda t: t.split()[0] if t else "",
        )

    def val():
        ann = root / (val_ann_file or "v2_mscoco_val2014_annotations.json")
        return _join_vqa_split(
            root / "v2_OpenEnded_mscoco_val2014_questions.json",
            ann,
            val_coco_dataset_root,
            "val2014",
            lambda a: a["multiple_choice_answer"],
            lambda t: t.split()[0] if t else "",
        )

    if split == "train":
        return train()
    if split == "validation":
        return val()
    return {"train": train(), "validation": val()}


def load_okvqa_ds(
    root_dir: str,
    train_coco_dataset_root: str,
    val_coco_dataset_root: str,
    split: Optional[str] = None,
):
    root = Path(root_dir)

    def mk(split2014, coco_root):
        return _join_vqa_split(
            root / f"OpenEnded_mscoco_{split2014}_questions.json",
            root / f"mscoco_{split2014}_annotations.json",
            coco_root,
            split2014,
            lambda a: a["answers"][0]["answer"] if a.get("answers") else "",
            lambda t: t,
        )

    if split == "train":
        return mk("train2014", train_coco_dataset_root)
    if split == "validation":
        return mk("val2014", val_coco_dataset_root)
    return {
        "train": mk("train2014", train_coco_dataset_root),
        "validation": mk("val2014", val_coco_dataset_root),
    }


def load_coco_ds(
    train_coco_dataset_root: str,
    val_coco_dataset_root: str,
    train_coco_annotation_file: str,
    val_coco_annotation_file: str,
    split: Optional[str] = None,
):
    def mk(ann_file, img_root):
        data = _load_json(ann_file)
        file_by_id = {im["id"]: im["file_name"] for im in data["images"]}
        caps: dict[int, list[str]] = {}
        for ann in data["annotations"]:
            caps.setdefault(ann["image_id"], []).append(ann["caption"])
        rows = []
        for image_id in sorted(caps):
            rows.append(
                {
                    "image_id": image_id,
                    "image": str(Path(img_root) / file_by_id[image_id]),
                    "single_caption": caps[image_id][0],
                    "captions": caps[image_id],
                }
            )
        for i, r in enumerate(rows):
            r["idx"] = i
        return Table(rows)

    if split == "train":
        return mk(train_coco_annotation_file, train_coco_dataset_root)
    if split == "validation":
        return mk(val_coco_annotation_file, val_coco_dataset_root)
    return {
        "train": mk(train_coco_annotation_file, train_coco_dataset_root),
        "validation": mk(val_coco_annotation_file, val_coco_dataset_root),
    }
