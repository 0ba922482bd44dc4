"""Chat-style VLM pretraining datasets over LLaVA-style JSON (copy of
vla_adapter_tpu/data/chat.py; the reference's AlignDataset and
FinetuneDataset).

Record: {"image": "rel/path.jpg"?, "conversations": [{"from": "human",
"value": "<image>\\n..."}, {"from": "gpt", "value": ...}, ...]}.

* :class:`AlignDataset`: projector alignment, "{caption}<eos>" with the
  loss on the caption (token 0, the patch splice's anchor, ignored).
* :class:`FinetuneDataset`: the whole chat through the family's prompt
  builder, the loss on gpt turns only.

Both give fixed-shape numpy examples: input_ids, labels, text_valid
(``max_text_tokens``) and, where the record has an image and an image
processor is given, pixel_values (1, H, W, C).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from vla_adapter_torch.core.constants import IGNORE_INDEX
from vla_adapter_torch.data.prompting import PROMPT_BUILDERS


class _ChatDatasetBase:
    def __init__(
        self,
        records: Union[List[Dict], str, Path],
        tokenize: Callable[[str], List[int]],
        image_processor: Optional[Callable] = None,
        image_root: Optional[str] = None,
        max_text_tokens: int = 512,
        eos_token_id: int = 151643,
    ):
        if not isinstance(records, list):
            records = json.loads(Path(records).read_text())
        self.records = records
        self.tokenize = tokenize
        self.image_processor = image_processor
        self.image_root = Path(image_root) if image_root else None
        self.max_text_tokens = max_text_tokens
        self.eos_token_id = eos_token_id

    def __len__(self) -> int:
        return len(self.records)

    def _pixels(self, record) -> Optional[np.ndarray]:
        if "image" not in record or self.image_processor is None:
            return None
        from PIL import Image

        path = record["image"]
        if self.image_root is not None:
            path = self.image_root / path
        return self.image_processor(Image.open(path))[None]

    def _pack(self, ids: List[int], labels: List[int]) -> Dict[str, np.ndarray]:
        t = self.max_text_tokens
        ids, labels = ids[:t], labels[:t]
        out_ids = np.zeros((t,), np.int32)
        out_lab = np.full((t,), IGNORE_INDEX, np.int32)
        valid = np.zeros((t,), np.int32)
        out_ids[:len(ids)] = ids
        out_lab[:len(labels)] = labels
        valid[:len(ids)] = 1
        return {"input_ids": out_ids, "labels": out_lab, "text_valid": valid}

    def _with_pixels(self, ex, record):
        px = self._pixels(record)
        if px is not None:
            ex["pixel_values"] = px
        return ex


class AlignDataset(_ChatDatasetBase):
    """Projector alignment: caption-only objective."""

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        record = self.records[i]
        caption = record["conversations"][-1]["value"] \
            .replace("<image>", "").strip()
        ids = list(self.tokenize(caption)) + [self.eos_token_id]
        labels = list(ids)
        labels[0] = IGNORE_INDEX  # the splice anchor: not image-aware
        return self._with_pixels(self._pack(ids, labels), record)


class FinetuneDataset(_ChatDatasetBase):
    """Multi-turn chat with the loss on gpt turns only."""

    def __init__(self, *args, prompt_family: str = "qwen", **kwargs):
        super().__init__(*args, **kwargs)
        self.prompt_family = prompt_family

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        record = self.records[i]
        builder = PROMPT_BUILDERS[self.prompt_family]("openvla")
        ids: List[int] = []
        labels: List[int] = []
        for turn in record["conversations"]:
            role = "human" if turn["from"] == "human" else "gpt"
            before = builder.prompt
            builder.add_turn(role, turn["value"])
            seg_ids = list(self.tokenize(builder.prompt[len(before):]))
            ids.extend(seg_ids)
            labels.extend(seg_ids if role == "gpt"
                          else [IGNORE_INDEX] * len(seg_ids))
        return self._with_pixels(self._pack(ids, labels), record)
