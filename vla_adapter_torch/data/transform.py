"""Frame -> training example, and prompt ids for serving (copy of
vla_adapter_tpu/data/transform.py, the reference's RLDSBatchTransform).

The text row is fixed-shape, padded to ``cfg.max_text_tokens``: in
training [prompt | the chunk's Q action-token ids | pad], at serving
[prompt | Q query placeholders | STOP | pad], each with ``prompt_len`` and
a validity row. The prompt is the Qwen chat prompt of the instruction
with the three trailing tokens of the empty assistant turn stripped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.core.constants import IGNORE_INDEX, STOP_INDEX
from vla_adapter_torch.data.action_tokenizer import ActionTokenizer
from vla_adapter_torch.data.image_processing import ImageProcessor
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


def pad_action_ids(flat_ids: List[int], num_tokens: int,
                   rng: np.random.Generator) -> List[int]:
    """The flattened action-token ids cut or padded to exactly
    ``num_tokens``; the padding samples the ids with replacement."""
    if num_tokens < len(flat_ids):
        return flat_ids[:num_tokens]
    extra = rng.choice(np.asarray(flat_ids), size=num_tokens - len(flat_ids),
                       replace=True).tolist()
    return flat_ids + extra


@dataclass
class VLABatchTransform:
    """RLDS frame -> model-format example.

    A frame: ``observation/image_primary`` (optionally with a leading
    window axis of 1) and the wrist cameras (keys containing "wrist"),
    uint8; ``observation/proprio``; ``task/language_instruction`` (str or
    bytes); ``action`` (chunk, action_dim), normalized; ``dataset_name``.
    ``seed`` seeds the generator that pads the action ids, as in the JAX
    package (the same ids from the same seed)."""

    cfg: VLAConfig
    tokenize: Callable[[str], List[int]]
    action_tokenizer: ActionTokenizer
    image_processor: ImageProcessor = field(default_factory=ImageProcessor)
    use_wrist_image: bool = True
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @staticmethod
    def _first(x):
        x = np.asarray(x)
        return x[0] if x.ndim >= 4 or (x.ndim == 2 and x.shape[0] == 1) else x

    def __call__(self, frame: Dict[str, Any]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        consts = cfg.constants
        num_q = consts.num_action_query_tokens
        t_max = cfg.max_text_tokens

        lang = frame["task"]["language_instruction"]
        if isinstance(lang, bytes):
            lang = lang.decode()
        actions = np.asarray(frame["action"], np.float32)
        chunk = (consts.num_actions_chunk, consts.action_dim)
        if actions.shape != chunk:
            raise ValueError(f"action chunk of shape {actions.shape}, "
                             f"expected {chunk}")

        prompt_ids = encode_prompt(self.tokenize, lang)
        flat = self.action_tokenizer.encode_to_ids(actions).reshape(-1)
        action_ids = pad_action_ids(flat.tolist(), num_q, self._rng)
        p = len(prompt_ids)
        # +1: a prompt that trains must also serve, where a STOP follows
        # the query block
        if p + num_q + 1 > t_max:
            raise ValueError(f"prompt of {p} tokens + {num_q} action ids + "
                             f"STOP exceeds max_text_tokens={t_max}")
        input_ids = np.zeros((t_max,), np.int32)
        input_ids[:p] = prompt_ids
        input_ids[p:p + num_q] = action_ids
        valid = np.zeros((t_max,), np.int32)
        valid[:p + num_q] = 1
        # the discrete objective's labels: the last prompt token and the
        # action ids
        labels = np.full((t_max,), IGNORE_INDEX, np.int32)
        labels[p - 1:p + num_q] = input_ids[p - 1:p + num_q]

        obs = frame["observation"]
        images = [self.image_processor(self._first(obs["image_primary"]))]
        if self.use_wrist_image:
            images += [self.image_processor(self._first(obs[k]))
                       for k in sorted(obs) if "wrist" in k]
        if len(images) != cfg.vision.num_images:
            raise ValueError(f"{len(images)} camera images, the model takes "
                             f"{cfg.vision.num_images}")
        out = {
            "input_ids": input_ids,
            "prompt_len": np.int32(p),
            "text_valid": valid,
            "labels": labels,
            "pixel_values": np.stack(images, axis=0),
            "actions": actions,
            "dataset_name": frame.get("dataset_name", ""),
        }
        if cfg.use_proprio and "proprio" in obs:
            out["proprio"] = np.asarray(obs["proprio"],
                                        np.float32).reshape(-1)
        return out

    def inference_ids(self, instruction: str
                      ) -> Tuple[np.ndarray, np.int32, np.ndarray]:
        """(input_ids, prompt_len, valid) for predict_action, with this
        transform's config and tokenizer (:func:`inference_ids`)."""
        return inference_ids(self.cfg, self.tokenize, instruction)
