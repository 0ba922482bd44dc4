"""Tokenizers (counterpart of vla_adapter_tpu/data/tokenization.py): the
checkpoint's Qwen2 BPE tokenizer through ``transformers``, and a
deterministic stand-in for runs without tokenizer files."""

from __future__ import annotations

import hashlib
from types import SimpleNamespace


NUM_EXTRA_TOKENS = 256


def load_qwen_tokenizer(config_dir: str,
                        num_extra_tokens: int = NUM_EXTRA_TOKENS):
    """The Qwen2 BPE tokenizer of a checkpoint directory (vocab.json +
    merges.txt), offline, extended with the ``<|extra_i|>`` action tokens
    as the reference does. ``transformers`` is imported here, and only
    here: without it this raises ImportError (pass ``tokenize=`` to
    ``load_vla`` instead)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as err:
        raise ImportError(
            "load_qwen_tokenizer needs the transformers package; without "
            "it, pass load_vla(tokenize=...) a text -> ids function") from err
    tok = AutoTokenizer.from_pretrained(config_dir, local_files_only=True)
    if num_extra_tokens > 0:
        added = tok.add_tokens([f"<|extra_{i}|>"
                                for i in range(num_extra_tokens)])
        if added != num_extra_tokens:
            raise ValueError(f"{config_dir}: added {added} of "
                             f"{num_extra_tokens} extra tokens")
    return tok


class MockTokenizer:
    """Deterministic stand-in for runs without tokenizer assets: words map
    to pseudo-ids by hashing. ``max_prompt_id`` bounds the ids so small test
    vocabularies hold them; ``len()`` is the extended Qwen2.5 tokenizer's
    (the action tokenizer's offset)."""

    def __init__(self, length: int = 151921, max_prompt_id: int = 400):
        self._len = length
        self._max_prompt_id = max_prompt_id

    def __len__(self) -> int:
        return self._len

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = []
        for w in text.split(" "):
            h = int(hashlib.md5(w.encode()).hexdigest()[:6], 16)
            ids.append(3 + h % (self._max_prompt_id - 3))
        return SimpleNamespace(input_ids=ids)

    def encode(self, text: str, add_special_tokens: bool = True):
        return self(text).input_ids

    def decode(self, ids):
        """Each id as ``<id>``, joined by spaces (ids carry no words)."""
        return " ".join(f"<{i}>" for i in ids)


class TextToIds:
    """``text -> ids`` of a tokenizer (special tokens added), as an object
    that pickles into ``DataLoader`` workers where a lambda would not."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def __call__(self, text: str):
        return list(self.tokenizer(text, add_special_tokens=True).input_ids)
