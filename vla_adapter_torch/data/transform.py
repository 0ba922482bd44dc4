"""Prompt ids for serving (copy of the inference part of
vla_adapter_tpu/data/transform.py).

The text row is fixed-shape: [prompt | Q query placeholders | STOP | pad]
padded to ``cfg.max_text_tokens``, with ``prompt_len`` and a validity row.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.core.constants import STOP_INDEX
from vla_adapter_torch.data.prompting import QwenPromptBuilder


def build_vla_prompt(instruction: str) -> str:
    """The chat prompt of every sample."""
    b = QwenPromptBuilder()
    b.add_turn("human",
               f"What action should the robot take to {instruction.lower()}?")
    b.add_turn("gpt", "")
    return b.get_prompt()


def encode_prompt(tokenize: Callable[[str], List[int]],
                  instruction: str) -> List[int]:
    """Prompt ids with the trailing [' ', <|im_end|>, EOS] triple stripped."""
    ids = list(tokenize(build_vla_prompt(instruction)))
    if len(ids) >= 3:
        del ids[-3:]
    return ids


def inference_ids(cfg: VLAConfig, tokenize: Callable[[str], List[int]],
                  instruction: str) -> Tuple[np.ndarray, np.int32, np.ndarray]:
    """(input_ids, prompt_len, valid): prompt + Q placeholders + STOP."""
    num_q = cfg.constants.num_action_query_tokens
    t_max = cfg.max_text_tokens
    prompt_ids = encode_prompt(tokenize, instruction)
    p = len(prompt_ids)
    if p + num_q + 1 > t_max:
        raise ValueError(f"prompt of {p} tokens + {num_q} queries + STOP "
                         f"exceeds max_text_tokens={t_max}")
    input_ids = np.zeros((t_max,), np.int32)
    input_ids[:p] = prompt_ids
    input_ids[p:p + num_q] = 1  # placeholders (embeddings replaced)
    input_ids[p + num_q] = STOP_INDEX
    valid = np.zeros((t_max,), np.int32)
    valid[:p + num_q + 1] = 1
    return input_ids, np.int32(p), valid
