"""The Qwen chat prompt builder (copy of the part of
vla_adapter_tpu/data/prompting.py that serving uses)."""

from __future__ import annotations

from typing import Optional

QWEN_SYSTEM_PROMPT = (
    "You are Qwen, created by Alibaba Cloud. You are a helpful assistant."
)


class QwenPromptBuilder:
    """ChatML: system and user turns are wrapped in
    <|im_start|>role\\n...<|im_end|>\\n; an empty assistant reply becomes a
    single space; a trailing assistant turn swaps its final newline for
    <|endoftext|>."""

    IM_START = "<|im_start|>"
    IM_END = "<|im_end|>"
    EOS = "<|endoftext|>"

    def __init__(self, system_prompt: Optional[str] = None):
        self.system_prompt = (system_prompt or QWEN_SYSTEM_PROMPT).strip()
        self.prompt = ""
        self.turn_count = 0

    def add_turn(self, role: str, message: str) -> str:
        expected = "human" if self.turn_count % 2 == 0 else "gpt"
        if role != expected:
            raise ValueError(f"turn {self.turn_count}: expected {expected}, "
                             f"got {role}")
        message = message.replace("<image>", "").strip()
        if self.turn_count == 0 and self.system_prompt:
            self.prompt += (
                f"{self.IM_START}system\n{self.system_prompt}{self.IM_END}\n")
        if role == "human":
            wrapped = (f"{self.IM_START}user\n{message}{self.IM_END}\n"
                       f"{self.IM_START}assistant\n")
        else:
            wrapped = f"{message if message else ' '}{self.IM_END}\n"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        if self.turn_count % 2 == 0:  # ended on a gpt turn: newline -> EOS
            return self.prompt[:-1] + self.EOS
        return self.prompt
