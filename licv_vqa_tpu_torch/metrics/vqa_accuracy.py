"""VQA accuracy: official normalization + 10-annotator consensus.

Behavioral spec (reference: icv_src/metrics/vqa_metric.py — the reference's
VENDORED copy of the official VQA eval): normalize punctuation (conditional
space/removal rule), strip periods, map number words, drop articles, restore
contractions; then accuracy per question = mean over leave-one-out annotator
subsets of ``min(#matching_other_annotators / 3, 1)``; report ``overall`` /
``perQuestionType`` / ``perAnswerType`` as percentages rounded to 2 places.

KNOWN DEVIATION FROM UPSTREAM (deliberate, for reference parity): the
ORIGINAL VQA eval normalizes pred/GT only when the 10 GT answers disagree
(``len(set(gtAnswers)) > 1``); the reference's vendored copy normalizes
UNCONDITIONALLY (vqa_metric.py:404-420 — no such guard), and so does this
module (and the C++ scorer).  On unanimous-GT questions whose match depends
on normalization (pred "two" vs GT "2"), this scores 1.0 where upstream
scores 0.0 — matching what the reference actually computes.

The entry point consumes in-memory predictions plus the standard question /
annotation JSON files (same file contract as the reference,
inference.py:146-153).
"""

from __future__ import annotations

import json
import re
from typing import Iterable, Mapping

from .normalization_data import ARTICLES, CONTRACTIONS, NUMBER_MAP, PUNCTUATION

_PERIOD_RE = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_IN_NUMBER_RE = re.compile(r"(\d)(\,)(\d)")
_ARTICLES = set(ARTICLES)


def _strip_punctuation(text: str) -> str:
    out = text
    for p in PUNCTUATION:
        # official rule: remove the mark when it abuts a space (or the string
        # has digit-comma-digit), otherwise replace it with a space
        if (p + " " in text or " " + p in text) or _COMMA_IN_NUMBER_RE.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_RE.sub("", out)


def _normalize_words(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = NUMBER_MAP.get(word, word)
        if word not in _ARTICLES:
            words.append(CONTRACTIONS.get(word, word))
    return " ".join(words)


def normalize_vqa_answer(text: str) -> str:
    text = text.replace("\n", " ").replace("\t", " ").strip()
    return _normalize_words(_strip_punctuation(text))


def _consensus_accuracy(pred_norm: str, gt_answers_norm: list[str]) -> float:
    n = len(gt_answers_norm)
    total_matches = sum(1 for a in gt_answers_norm if a == pred_norm)
    acc = 0.0
    for i, a in enumerate(gt_answers_norm):
        matches = total_matches - (1 if a == pred_norm else 0)
        acc += min(1.0, matches / 3.0)
    return acc / n


def compute_vqa_accuracy(
    results: Iterable[Mapping],  # [{"answer": str, "question_id": int}, ...]
    question_json_path: str,
    annotation_json_path: str,
) -> dict:
    """Pure-Python scoring: the JAX package's ctypes C++ scorer is not
    carried over (its Python fallback, this path, gives the same numbers)."""
    with open(annotation_json_path) as f:
        annotations = {a["question_id"]: a for a in json.load(f)["annotations"]}
    with open(question_json_path) as f:
        json.load(f)  # validated for existence/format parity; ids come from anns

    overall: list[float] = []
    per_qtype: dict[str, list[float]] = {}
    per_atype: dict[str, list[float]] = {}
    per_question: dict[int, float] = {}

    for res in results:
        qid = res["question_id"]
        ann = annotations[qid]
        pred = normalize_vqa_answer(str(res["answer"]))
        gts = [normalize_vqa_answer(a["answer"]) for a in ann["answers"]]
        acc = _consensus_accuracy(pred, gts)
        overall.append(acc)
        per_question[qid] = round(100 * acc, 2)
        per_qtype.setdefault(ann.get("question_type", ""), []).append(acc)
        per_atype.setdefault(ann.get("answer_type", "other"), []).append(acc)

    def pct(values: list[float]) -> float:
        return round(100 * sum(values) / len(values), 2) if values else 0.0

    return {
        "overall": pct(overall),
        "perQuestionType": {k: pct(v) for k, v in per_qtype.items()},
        "perAnswerType": {k: pct(v) for k, v in per_atype.items()},
        "perQuestion": per_question,
    }


def postprocess_vqa_generation(prediction: str) -> str:
    """Cut the generation at the next prompt keyword, then at ", "
    (reference: vqa_metric.py:558-561)."""
    answer = re.split(r"Question|Answer|Short", prediction, maxsplit=1)[0]
    return re.split(r", ", answer, maxsplit=1)[0]
