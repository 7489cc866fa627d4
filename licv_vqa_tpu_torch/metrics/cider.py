"""CIDEr-D scorer in pure Python (no pycocoevalcap / no Java PTBTokenizer).

The reference shells out to pycocoevalcap (vendored COCOEvalCap, reference:
icv_src/metrics/cider.py), whose PTBTokenizer spawns a JVM — SURVEY.md §2.4
plans dropping it.  This module implements the same pipeline host-side:

1. PTB-style tokenization: Treebank rules, lowercased, standard punctuation
   token set removed (the PTBTokenizer contract);
2. CIDEr-D (Vedantam et al. 2015) as implemented by pycocoevalcap:
   1..4-gram TF-IDF vectors, count clipping, per-n cosine with a Gaussian
   length penalty (σ=6), ×10, averaged over n and references.

Entry point mirrors the reference: ``compute_cider(results, ann_path)`` with
``results = [{"image_id": int, "caption": str}]`` against a COCO captions
annotation file; returns the corpus CIDEr score (caller ×100).
"""

from __future__ import annotations

import json
import math
from collections import Counter, defaultdict
from typing import Iterable, Mapping

from .nlp import word_tokenize

_PTB_PUNCT = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}
# Stanford PTBTokenizer escapes brackets (and -lowerCase lowercases the
# escapes, so pycocoevalcap's UPPERCASE filter list never removes them —
# bracket tokens survive into the n-grams).  nltk's Treebank tokenizer
# leaves literal brackets; rename to match the Stanford stream.
_BRACKET_ESCAPES = {
    "(": "-lrb-", ")": "-rrb-", "{": "-lcb-", "}": "-rcb-",
    "[": "-lsb-", "]": "-rsb-",
}
_SIGMA = 6.0
_MAX_N = 4


def ptb_tokenize(text: str) -> list[str]:
    toks = word_tokenize(text.lower().replace("\n", " "))
    return [
        _BRACKET_ESCAPES.get(t, t) for t in toks if t not in _PTB_PUNCT
    ]


def _ngram_counts(tokens: list[str]) -> list[Counter]:
    out = []
    for n in range(1, _MAX_N + 1):
        out.append(Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)))
    return out


def _similarity(
    hyp: list[Counter],
    ref: list[Counter],
    hyp_len: int,
    ref_len: int,
    doc_freq: dict,
    log_n: float,
) -> list[float]:
    scores = []
    delta = float(hyp_len - ref_len)
    penalty = math.exp(-(delta**2) / (2 * _SIGMA**2))
    for n in range(_MAX_N):
        num, norm_h, norm_r = 0.0, 0.0, 0.0
        hyp_vec = {
            g: c * max(log_n - math.log(max(1.0, doc_freq.get(g, 0.0))), 0.0)
            for g, c in hyp[n].items()
        }
        ref_vec = {
            g: c * max(log_n - math.log(max(1.0, doc_freq.get(g, 0.0))), 0.0)
            for g, c in ref[n].items()
        }
        for g, v in hyp_vec.items():
            num += min(v, ref_vec.get(g, 0.0)) * ref_vec.get(g, 0.0)
        norm_h = math.sqrt(sum(v * v for v in hyp_vec.values()))
        norm_r = math.sqrt(sum(v * v for v in ref_vec.values()))
        s = num / (norm_h * norm_r) if norm_h and norm_r else 0.0
        scores.append(s * penalty)
    return scores


def cider_d(
    hypotheses: Mapping[int, str], references: Mapping[int, list[str]]
) -> tuple[float, dict[int, float]]:
    """Corpus CIDEr-D over {id: caption} vs {id: [refs...]}."""
    ids = list(hypotheses.keys())
    hyp_tok = {i: ptb_tokenize(hypotheses[i]) for i in ids}
    ref_tok = {i: [ptb_tokenize(r) for r in references[i]] for i in ids}

    # document frequency over reference sets (ngram counted once per image)
    doc_freq: dict = defaultdict(float)
    for i in ids:
        seen = set()
        for ref in ref_tok[i]:
            for counts in _ngram_counts(ref):
                seen.update(counts.keys())
        for g in seen:
            doc_freq[g] += 1.0
    log_n = math.log(max(len(ids), 1))

    per_image: dict[int, float] = {}
    for i in ids:
        hyp_counts = _ngram_counts(hyp_tok[i])
        per_ref = []
        for ref in ref_tok[i]:
            sims = _similarity(
                hyp_counts,
                _ngram_counts(ref),
                len(hyp_tok[i]),
                len(ref),
                doc_freq,
                log_n,
            )
            per_ref.append(sims)
        # average over refs per n, then over n, ×10 (pycocoevalcap order)
        score = 0.0
        for n in range(_MAX_N):
            score += sum(r[n] for r in per_ref) / max(len(per_ref), 1)
        per_image[i] = score / _MAX_N * 10.0
    overall = sum(per_image.values()) / max(len(per_image), 1)
    return overall, per_image


def compute_cider(
    results: Iterable[Mapping],  # [{"image_id": int, "caption": str}]
    annotation_json_path: str,
) -> float:
    with open(annotation_json_path) as f:
        data = json.load(f)
    refs: dict[int, list[str]] = defaultdict(list)
    for ann in data["annotations"]:
        refs[ann["image_id"]].append(ann["caption"])
    hyps = {r["image_id"]: r["caption"] for r in results}
    overall, _ = cider_d(hyps, {i: refs[i] for i in hyps})
    return overall
