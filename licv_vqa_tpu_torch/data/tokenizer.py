"""Tokenizer protocol: a thin wrapper over HF tokenizers plus a dependency-free
whitespace tokenizer for tests/synthetic runs (the reference's tokenizer comes
bundled inside ``lmm_icl_interface`` processors; here it is explicit)."""

from __future__ import annotations

from typing import Iterable, Protocol, Sequence


class Tokenizer(Protocol):
    pad_token_id: int
    bos_token_id: int
    eos_token_id: int

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...

    def token_id(self, token: str) -> int: ...


class WhitespaceTokenizer:
    """Deterministic hash-free toy tokenizer: builds its vocab on the fly.

    Special ids mirror LLaMA conventions (pad=0, bos=1, eos=2) so collator /
    decode logic is exercised identically to the real stack.
    """

    SPECIALS = ["<pad>", "<s>", "</s>", "<image>", "<fake_token_around_image>"]

    def __init__(self, vocab: Iterable[str] = ()):
        self._tok_to_id: dict[str, int] = {t: i for i, t in enumerate(self.SPECIALS)}
        self._id_to_tok: list[str] = list(self.SPECIALS)
        for t in vocab:
            self._add(t)
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2

    def _add(self, tok: str) -> int:
        if tok not in self._tok_to_id:
            self._tok_to_id[tok] = len(self._id_to_tok)
            self._id_to_tok.append(tok)
        return self._tok_to_id[tok]

    def token_id(self, token: str) -> int:
        return self._add(token)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [self.bos_token_id] if add_bos else []
        # split on whitespace but keep special tokens intact
        for piece in text.replace("\n", " \\n ").split():
            ids.append(self._add(piece))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i >= len(self._id_to_tok):
                continue
            if skip_special_tokens and i < len(self.SPECIALS):
                continue
            toks.append(self._id_to_tok[i])
        return " ".join(t for t in toks if t != "\\n")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_tok)


class HFTokenizer:
    """Adapter over a ``transformers`` tokenizer."""

    def __init__(self, tok):
        self.tok = tok
        self.pad_token_id = tok.pad_token_id
        self.bos_token_id = tok.bos_token_id
        self.eos_token_id = tok.eos_token_id
        if self.pad_token_id is None:
            self.pad_token_id = tok.unk_token_id or 0

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return self.tok.batch_decode(batch, skip_special_tokens=skip_special_tokens)

    def token_id(self, token: str) -> int:
        return self.tok.convert_tokens_to_ids(token)

    @property
    def vocab_size(self) -> int:
        return len(self.tok)


def load_hf_tokenizer(name_or_path: str) -> HFTokenizer:
    from transformers import AutoTokenizer

    return HFTokenizer(AutoTokenizer.from_pretrained(name_or_path))
