"""Prompt builders for each LLM family (copy of
vla_adapter_tpu/data/prompting.py; the reference's
prismatic/models/backbones/llm/prompting/). The Qwen builder is on the
serving path (``data/transform.py``); ``FinetuneDataset`` and the
generation REPL pick one by family from :data:`PROMPT_BUILDERS`.

Every builder alternates human and gpt turns (another order raises
ValueError), drops ``<image>`` from a message and strips it.
"""

from __future__ import annotations

from typing import Optional

QWEN_SYSTEM_PROMPT = (
    "You are Qwen, created by Alibaba Cloud. You are a helpful assistant."
)
LLAVA_SYSTEM_PROMPT = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)
VICUNA_SYSTEM_PROMPT = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)


class PromptBuilder:
    """Alternating human/gpt turn accumulator."""

    def __init__(self, model_family: str = "openvla",
                 system_prompt: Optional[str] = None):
        self.model_family = model_family
        self.system_prompt = system_prompt
        self.prompt = ""
        self.turn_count = 0

    def _message(self, role: str, message: str) -> str:
        expected = "human" if self.turn_count % 2 == 0 else "gpt"
        if role != expected:
            raise ValueError(f"turn {self.turn_count}: expected {expected}, "
                             f"got {role}")
        return message.replace("<image>", "").strip()

    def add_turn(self, role: str, message: str) -> str:
        raise NotImplementedError

    def get_prompt(self) -> str:
        raise NotImplementedError


class QwenPromptBuilder(PromptBuilder):
    """ChatML: system and user turns are wrapped in
    <|im_start|>role\\n...<|im_end|>\\n; an empty assistant reply becomes a
    single space; a trailing assistant turn swaps its final newline for
    <|endoftext|>."""

    IM_START = "<|im_start|>"
    IM_END = "<|im_end|>"
    EOS = "<|endoftext|>"

    def __init__(self, model_family: str = "openvla",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family,
                         (system_prompt or QWEN_SYSTEM_PROMPT).strip())

    def add_turn(self, role: str, message: str) -> str:
        message = self._message(role, message)
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


class PurePromptBuilder(PromptBuilder):
    """The legacy OpenVLA format: 'In: {q}\\nOut: ', '</s>' closing each
    gpt turn."""

    BOS, EOS = "<s>", "</s>"

    def add_turn(self, role: str, message: str) -> str:
        message = self._message(role, message)
        wrapped = (f"In: {message}\nOut: " if role == "human"
                   else f"{message}{self.EOS}")
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        return self.prompt.rstrip()


class _InstPromptBuilder(PromptBuilder):
    """[INST]-family: human '[INST] q [/INST] ', gpt 'a</s>' (empty -> a
    single space); trailing whitespace stripped. The prompt carries no
    '<s>': the tokenizer adds it."""

    def _wrap_first_human(self, message: str) -> str:
        return f"[INST] {message} [/INST] "

    def _wrap_human(self, message: str) -> str:
        return f"[INST] {message} [/INST] "

    def _wrap_gpt(self, message: str) -> str:
        return f"{message if message else ' '}</s>"

    def add_turn(self, role: str, message: str) -> str:
        message = self._message(role, message)
        if self.turn_count == 0:
            wrapped = self._wrap_first_human(message)
        elif role == "human":
            wrapped = self._wrap_human(message)
        else:
            wrapped = self._wrap_gpt(message)
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        return self.prompt.rstrip()


class Llama2ChatPromptBuilder(_InstPromptBuilder):
    """LLaMA-2-chat, with the reference's asymmetric
    '<<SYS>\\n...\\n<</SYS>>\\n\\n' system wrapper kept verbatim."""

    def __init__(self, model_family: str = "openvla",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        sys_prompt = LLAVA_SYSTEM_PROMPT if system_prompt is None \
            else system_prompt
        self.system_prompt = f"<<SYS>\n{sys_prompt.strip()}\n<</SYS>>\n\n"

    def _wrap_first_human(self, message: str) -> str:
        return self._wrap_human(self.system_prompt + message)


class VicunaPromptBuilder(_InstPromptBuilder):
    """Vicuna v1.5: a system prefix and 'USER: q ASSISTANT: ' turns."""

    def __init__(self, model_family: str = "openvla",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        self.system_prompt = (
            VICUNA_SYSTEM_PROMPT if system_prompt is None else system_prompt
        ).strip() + " "

    def _wrap_human(self, message: str) -> str:
        return f"USER: {message} ASSISTANT: "

    def _wrap_first_human(self, message: str) -> str:
        return self.system_prompt + self._wrap_human(message)


class MistralInstructPromptBuilder(_InstPromptBuilder):
    """Mistral-Instruct: no system prompt, plain [INST] wrapping."""


class PhiPromptBuilder(PromptBuilder):
    """Phi-2's Input/Output format: an explicit <|endoftext|> BOS on the
    first turn, an EOS after each gpt turn."""

    BOS = EOS = "<|endoftext|>"

    def add_turn(self, role: str, message: str) -> str:
        message = self._message(role, message)
        if self.turn_count == 0:
            wrapped = f"{self.BOS}Input: {message}\nOutput: "
        elif role == "human":
            wrapped = f"Input: {message}\nOutput: "
        else:
            wrapped = f"{message if message else ' '}\n{self.EOS}"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        return self.prompt.rstrip()


PROMPT_BUILDERS = {
    "qwen": QwenPromptBuilder,
    "pure": PurePromptBuilder,
    "llama2-chat": Llama2ChatPromptBuilder,
    "vicuna": VicunaPromptBuilder,
    "mistral-instruct": MistralInstructPromptBuilder,
    "phi": PhiPromptBuilder,
}
