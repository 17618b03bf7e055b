"""Tokenizers: the tokens.txt mapping and the character tokenizer.

Only the ``simple`` (character) tokenizer is ported so far; the espeak,
emilia, dialog and libritts front ends raise "not yet ported".
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional


def read_token_file(token_file: str) -> Dict[str, int]:
    token2id: Dict[str, int] = {}
    with open(token_file, encoding="utf-8") as f:
        for line in f:
            info = line.rstrip("\n").split("\t")
            token, idx = info[0], int(info[1])
            if token in token2id:
                raise ValueError(f"{token_file}: duplicate token {token!r}")
            token2id[token] = idx
    return token2id


def write_token_file(token2id: Dict[str, int], path: str):
    with open(path, "w", encoding="utf-8") as f:
        for token, idx in sorted(token2id.items(), key=lambda kv: kv[1]):
            f.write(f"{token}\t{idx}\n")


class Tokenizer:
    """Base: tokens.txt mapping + id conversion (OOV tokens are skipped)."""

    def __init__(self, token_file: Optional[str] = None):
        self.has_tokens = False
        self.token2id: Dict[str, int] = {}
        if token_file is not None:
            self.token2id = read_token_file(token_file)
            self.pad_id = self.token2id["_"]
            self.vocab_size = len(self.token2id)
            self.has_tokens = True

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        raise NotImplementedError

    def texts_to_token_ids(self, texts: List[str]) -> List[List[int]]:
        return self.tokens_to_token_ids(self.texts_to_tokens(texts))

    def tokens_to_token_ids(self, tokens_list: List[List[str]]) -> List[List[int]]:
        if not self.has_tokens:
            raise ValueError("Tokenizer needs a tokens file to map to ids.")
        out = []
        for tokens in tokens_list:
            ids = []
            for t in tokens:
                if t not in self.token2id:
                    logging.debug("Skip OOV %s", t)
                    continue
                ids.append(self.token2id[t])
            out.append(ids)
        return out


class SimpleTokenizer(Tokenizer):
    """Character tokenizer, no normalization."""

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        return [list(t) for t in texts]


_NOT_PORTED = ("emilia", "espeak", "dialog", "libritts")


def get_tokenizer(name: str, token_file: Optional[str] = None):
    """Named tokenizer factory; only ``simple`` is ported."""
    if name == "simple":
        return SimpleTokenizer(token_file)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"tokenizer {name!r} is not yet ported to zipvoice_tpu_torch "
            "(only 'simple' is)"
        )
    raise ValueError(f"Unsupported tokenizer: {name}")
