"""Interactive language-only generation REPL (counterpart of
vla_adapter_tpu/infer/generate_repl.py; the reference's
scripts/generate.py).

Reads a checkpoint's language model and tokenizer and completes each typed
prompt, wrapped by the family's prompt builder, through
``greedy_generate_cached`` (on the card, one CUDA graph per buffer
length). ``--temperature`` > 0 samples from a generator seeded with
``--seed``.

    python -m vla_adapter_torch.infer.generate_repl --ckpt_dir <dir> \\
        [--max_new_tokens 64] [--temperature 0.7]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    ckpt_dir: str = ""
    image: str = ""
    max_new_tokens: int = 64
    temperature: float = 0.0
    prompt_family: str = "qwen"
    seed: int = 0
    device: str = "cuda"


def main(argv=None) -> None:
    from vla_adapter_torch.data.prompting import PROMPT_BUILDERS
    from vla_adapter_torch.data.tokenization import load_qwen_tokenizer
    from vla_adapter_torch.infer.predict import resolve_device
    from vla_adapter_torch.models.generate import greedy_generate_cached
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.llm import llm_model_class
    from vla_adapter_torch.weights.convert import llm_state_from_hf
    from vla_adapter_torch.weights.load import (
        load_hf_backbone_state_dict,
        vla_config_from_checkpoint,
    )

    cfg = parse_config(GenerateConfig, argv)
    if not cfg.ckpt_dir:
        raise SystemExit("--ckpt_dir is required")
    device = resolve_device(cfg.device)
    llm_cfg = vla_config_from_checkpoint(cfg.ckpt_dir).llm
    tok = load_qwen_tokenizer(cfg.ckpt_dir)
    rt = Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    llm = llm_model_class(llm_cfg)(llm_cfg, rt, device="meta")
    state = llm_state_from_hf(load_hf_backbone_state_dict(cfg.ckpt_dir),
                              llm_cfg, prefix="language_model.model.")
    llm.load_state_dict({k: v.to(device, rt.param_dtype)
                         for k, v in state.items()}, strict=True,
                        assign=True)
    llm.eval()
    generator = None
    if cfg.temperature > 0:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    log.info("loaded %s: language-only REPL (Ctrl-D to exit)", cfg.ckpt_dir)

    while True:
        try:
            text = input(">>> ")
        except EOFError:
            break
        builder = PROMPT_BUILDERS[cfg.prompt_family]("openvla")
        builder.add_turn("human", text)
        ids = tok(builder.get_prompt(), add_special_tokens=True).input_ids
        p = len(ids)
        buf = np.zeros((1, p + cfg.max_new_tokens), np.int64)
        buf[0, :p] = ids
        out = greedy_generate_cached(
            llm, torch.from_numpy(buf).to(device), prompt_len=p,
            max_new_tokens=cfg.max_new_tokens,
            eos_token_id=tok.eos_token_id, temperature=cfg.temperature,
            generator=generator)
        completion = out[0, p:].cpu().numpy()
        completion = completion[completion != 0]
        print(tok.decode(completion.tolist()))


if __name__ == "__main__":
    main()
