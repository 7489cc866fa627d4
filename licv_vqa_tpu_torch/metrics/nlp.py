"""Dependency-light NLP utilities for the OK-VQA stemmer.

The reference uses nltk (POS tagger + WordNet lemmatizer) and the
``inflection`` package (reference: icv_src/metrics/okvqa_utils.py:10-13).
In this image nltk's DATA packages (punkt/tagger/wordnet) are absent and
``inflection`` is not installed, so we provide:

- ``word_tokenize`` — nltk's TreebankWordTokenizer (pure regex, data-free);
- ``pos_tag`` — nltk's perceptron tagger when its data is installed, else a
  rule fallback sufficient for the single decision the stemmer needs
  (is this token a plural noun?);
- ``lemmatize_ing`` — WordNet when available, else standard -ing stripping
  rules (doubled consonant, +e restoration);
- ``singularize`` — a reimplementation of the Rails/``inflection`` rule set
  (public, MIT) so plural handling matches the reference's package.
"""

from __future__ import annotations

import re
from functools import lru_cache


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _treebank():
    from nltk.tokenize import TreebankWordTokenizer

    return TreebankWordTokenizer()


def word_tokenize(text: str) -> list[str]:
    return _treebank().tokenize(text)


# ---------------------------------------------------------------------------
# POS tagging (plural-noun detection is all the stemmer needs)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _nltk_tagger_available() -> bool:
    try:
        import nltk

        nltk.pos_tag(["test"])
        return True
    except LookupError:
        return False


_NOT_PLURAL_SUFFIXES = ("ss", "us", "is", "'s")

# irregular plurals nltk's perceptron tagger tags NNS without an -s suffix
_IRREGULAR_PLURALS = {
    "men", "women", "children", "people", "mice", "geese", "feet", "teeth",
    "oxen",
}


def _heuristic_tag(word: str) -> str:
    if word in _IRREGULAR_PLURALS:
        return "NNS"
    if (
        word.endswith("s")
        and len(word) > 3
        and not word.endswith(_NOT_PLURAL_SUFFIXES)
    ):
        return "NNS"
    return "NN"


def pos_tag(tokens: list[str]) -> list[tuple[str, str]]:
    if _nltk_tagger_available():
        import nltk

        return nltk.pos_tag(tokens)
    return [(t, _heuristic_tag(t)) for t in tokens]


# ---------------------------------------------------------------------------
# -ing lemmatization
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _wordnet_lemmatizer():
    try:
        from nltk.stem import WordNetLemmatizer

        lem = WordNetLemmatizer()
        lem.lemmatize("running", "v")  # force the corpus load
        return lem
    except LookupError:
        return None


_VOWELS = set("aeiou")


def lemmatize_ing(word: str) -> str:
    """WordNet verb lemma when the corpus is installed, else rule fallback.

    Fallback rules (validated against WordNet's output on common VQA-answer
    verbs — see tests/fixtures/metric_goldens.json):

    - vowel-less base ⇒ not a verb stem: string/swing/bring unchanged;
    - base ending in a vowel, y, or w: skiing→ski, playing→play, snowing→snow;
    - doubled final consonant (not l/s/z): running→run, sitting→sit;
    - consonant cluster: walking→walk — except soft-c clusters which restore
      the e: dancing→dance;
    - CVC tail restores the dropped e: taking→take, smiling→smile;
    - anything else (VVC tails etc.): eating→eat, looking→look.
    """
    lem = _wordnet_lemmatizer()
    if lem is not None:
        return lem.lemmatize(word, "v")
    if not word.endswith("ing") or len(word) <= 4:
        return word
    base = word[:-3]
    if not any(c in _VOWELS for c in base):
        return word  # string, swing, bring — WordNet leaves these alone
    if base[-1] in _VOWELS or base[-1] in "yw":
        return base  # ski, play, buy, snow, draw
    if len(base) >= 2 and base[-1] == base[-2] and base[-1] not in "lsz":
        return base[:-1]  # running → run
    if len(base) >= 2 and base[-2] not in _VOWELS:
        return base + "e" if base[-1] == "c" else base  # walk; dance
    if len(base) >= 3 and base[-2] in _VOWELS and base[-3] not in _VOWELS:
        return base + "e"  # take, smile, drive (CVC tail)
    return base  # eat, look, rain (VVC tail)


# ---------------------------------------------------------------------------
# Singularization (Rails inflector rules, as in the `inflection` package)
# ---------------------------------------------------------------------------

_SINGULAR_RULES = [
    (r"(?i)(quiz)zes$", r"\1"),
    (r"(?i)(matr)ices$", r"\1ix"),
    (r"(?i)(vert|ind)ices$", r"\1ex"),
    (r"(?i)^(ox)en", r"\1"),
    (r"(?i)(alias|status)(es)?$", r"\1"),
    (r"(?i)(octop|vir)(us|i)$", r"\1us"),
    (r"(?i)^(a)x[ie]s$", r"\1xis"),
    (r"(?i)(cris|test)(is|es)$", r"\1is"),
    (r"(?i)(shoe)s$", r"\1"),
    (r"(?i)(o)es$", r"\1"),
    (r"(?i)(bus)(es)?$", r"\1"),
    (r"(?i)^(m|l)ice$", r"\1ouse"),
    (r"(?i)(x|ch|ss|sh)es$", r"\1"),
    (r"(?i)(m)ovies$", r"\1ovie"),
    (r"(?i)(s)eries$", r"\1eries"),
    (r"(?i)([^aeiouy]|qu)ies$", r"\1y"),
    (r"(?i)([lr])ves$", r"\1f"),
    (r"(?i)(tive)s$", r"\1"),
    (r"(?i)(hive)s$", r"\1"),
    (r"(?i)([^f])ves$", r"\1fe"),
    (r"(?i)(t)he(sis|ses)$", r"\1hesis"),
    (r"(?i)(s)ynop(sis|ses)$", r"\1ynopsis"),
    (r"(?i)(p)rogno(sis|ses)$", r"\1rognosis"),
    (r"(?i)(p)arenthe(sis|ses)$", r"\1arenthesis"),
    (r"(?i)(d)iagno(sis|ses)$", r"\1iagnosis"),
    (r"(?i)(b)a(sis|ses)$", r"\1asis"),
    (r"(?i)(analy)(sis|ses)$", r"\1sis"),
    (r"(?i)([ti])a$", r"\1um"),
    (r"(?i)(n)ews$", r"\1ews"),
    (r"(?i)(ss)$", r"\1"),
    (r"(?i)s$", ""),
]

_IRREGULAR = {
    "people": "person",
    "men": "man",
    "women": "woman",
    "children": "child",
    "sexes": "sex",
    "moves": "move",
    "zombies": "zombie",
    "staff": "staff",
}

_UNCOUNTABLE = {
    "equipment",
    "information",
    "rice",
    "money",
    "species",
    "series",
    "fish",
    "sheep",
    "jeans",
    "police",
}


def singularize(word: str) -> str:
    low = word.lower()
    if low in _UNCOUNTABLE:
        return word
    if low in _IRREGULAR:
        return _IRREGULAR[low]
    for rule, repl in _SINGULAR_RULES:
        if re.search(rule, word):
            return re.sub(rule, repl, word)
    return word
