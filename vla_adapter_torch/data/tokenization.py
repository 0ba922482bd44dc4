"""Tokenizer stand-in (copy of MockTokenizer from
vla_adapter_tpu/data/tokenization.py)."""

from __future__ import annotations

import hashlib
from types import SimpleNamespace


class MockTokenizer:
    """Deterministic stand-in for runs without tokenizer assets: words map
    to pseudo-ids by hashing. ``max_prompt_id`` bounds the ids so small test
    vocabularies hold them."""

    def __init__(self, max_prompt_id: int = 400):
        self._max_prompt_id = max_prompt_id

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = []
        for w in text.split(" "):
            h = int(hashlib.md5(w.encode()).hexdigest()[:6], 16)
            ids.append(3 + h % (self._max_prompt_id - 3))
        return SimpleNamespace(input_ids=ids)

    def encode(self, text: str, add_special_tokens: bool = True):
        return self(text).input_ids
