"""OK-VQA v1.1 answer stemming.

Behavior per reference icv_src/metrics/okvqa_utils.py:185-215: for each
token, apply the manual override table first, else lemmatize ``-ing`` words
as verbs, else singularize plural nouns; join with spaces.  The postprocess
entry applies the VQA generation split rules first.
"""

from __future__ import annotations

import re

from .nlp import lemmatize_ing, pos_tag, singularize, word_tokenize
from .normalization_data import OKVQA_MANUAL_STEMS


class OKVQAStemmer:
    def stem(self, text: str) -> str:
        out = []
        for word, pos in pos_tag(word_tokenize(text)):
            if word in OKVQA_MANUAL_STEMS:
                word = OKVQA_MANUAL_STEMS[word]
            elif word.endswith("ing"):
                word = lemmatize_ing(word)
            elif pos.startswith("NNS") or pos.startswith("NNPS"):
                word = singularize(word)
            out.append(word)
        return " ".join(out)


_STEMMER = OKVQAStemmer()


def postprocess_ok_vqa_generation(prediction: str) -> str:
    prediction = re.split(r"Question|Answer|Short", prediction, maxsplit=1)[0]
    prediction = re.split(r", ", prediction, maxsplit=1)[0]
    return _STEMMER.stem(prediction)
