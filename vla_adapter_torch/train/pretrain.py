"""VLM pretraining (counterpart of vla_adapter_tpu/train/pretrain.py; the
reference's scripts/pretrain.py).

Stage-driven training of ``PrismaticVLM`` on chat data with the multimodal
CE objective: "align" trains the projector only, "finetune" the projector
and the LLM, "full-finetune" everything, "last-layer-finetune" the
embedding and the last decoder layer (``train/stages.py``).

    python -m vla_adapter_torch.train.pretrain --stage align \\
        --data_json llava_align.json --image_root images/ ...
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.core.config import OptimizerConfig, VLAConfig
from vla_adapter_torch.infer.predict import resolve_device
from vla_adapter_torch.models.layers import Runtime, init_random_
from vla_adapter_torch.models.vlm import PrismaticVLM
from vla_adapter_torch.train.optim import (
    apply_updates,
    make_optimizer,
    mask_updates,
)
from vla_adapter_torch.train.partition import mark_by_
from vla_adapter_torch.train.stages import stage_predicate, stage_update_mask
from vla_adapter_torch.train.step import to_device
from vla_adapter_torch.utils.overwatch import initialize_overwatch
from vla_adapter_torch.utils.profiling import StepTimer

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    model: VLAConfig = VLAConfig(use_proprio=False)
    optim: OptimizerConfig = OptimizerConfig(learning_rate=1e-3)
    stage: str = "align"
    batch_size: int = 16
    data_json: str = ""
    image_root: str = ""
    tokenizer_dir: Optional[str] = None
    max_text_tokens: int = 512
    seed: int = 7
    # Backbone weights to start from: a ``save_params`` directory (e.g. a
    # weights.merge output) or an HF-layout checkpoint directory. Aligning
    # a projector to random towers aligns it to noise.
    init_from: Optional[str] = None
    out_dir: str = "runs/pretrain"
    device: str = "cuda"


def make_pretrain_step(model: PrismaticVLM, tx,
                       trainable: Dict[str, torch.nn.Parameter]):
    """step(opt_state, batch) -> (opt_state, {"loss"}): the CE loss, the
    gradients of ``trainable`` (the model's own tensors, updated in
    place) and one optimizer update."""
    names = list(trainable)
    params = [trainable[n] for n in names]

    def step(opt_state, batch):
        loss = model(batch["input_ids"], batch["text_valid"],
                     batch.get("pixel_values"), labels=batch["labels"])["loss"]
        grads = torch.autograd.grad(loss, params)
        updates, opt_state = tx.update(dict(zip(names, grads)), opt_state,
                                       trainable)
        apply_updates(trainable, updates)
        return opt_state, {"loss": loss.detach()}

    return step


def graft(model: torch.nn.Module, init_params: Mapping[str, torch.Tensor]
          ) -> list:
    """Load ``init_params`` over the model by top-level module: every module
    that ``init_params`` has entries for is taken whole from it; entries of
    modules the model lacks (a VLA's action head) are ignored; modules it
    lacks keep their init. Returns the grafted module names."""
    state = model.state_dict()
    tops = sorted({k.split(".")[0] for k in init_params}
                  & {k.split(".")[0] for k in state})
    take = {k: init_params[k] for k in init_params if k.split(".")[0] in tops}
    missing = [k for k in state if k.split(".")[0] in tops and k not in take]
    unknown = [k for k in take if k not in state]
    if missing or unknown:
        raise KeyError(f"graft of {tops}: missing {missing[:5]}, unknown "
                       f"{unknown[:5]}")
    with torch.no_grad():
        for k, v in take.items():
            state[k].copy_(v)
    return tops


def pretrain(
    cfg: PretrainConfig,
    data_iter: Iterator[Dict[str, np.ndarray]],
    max_steps: int,
    rt: Optional[Runtime] = None,
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
    device: Optional[str] = None,
    timer: Optional[StepTimer] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``max_steps`` steps of ``cfg.stage`` on ``device`` (default
    ``cfg.device``, the card) from a seeded init (``cfg.seed``) with
    ``init_params`` grafted over it, each step timed by ``timer`` when
    given (a step ends when its loss reaches the host). Returns the final
    state dict and the last step's metrics ("loss"), with every step's
    loss under "losses"."""
    dev = resolve_device(device or cfg.device)
    rt = rt or Runtime(dtype=torch.bfloat16, param_dtype=torch.float32)
    model = PrismaticVLM(cfg.model, rt, device=dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(cfg.seed))
    if init_params is not None:
        log.info("initialized %s from pretrained weights",
                 graft(model, init_params))
    names = mark_by_(model, stage_predicate(cfg.stage))
    params = dict(model.named_parameters())
    trainable = {n: params[n] for n in names}
    tx = mask_updates(make_optimizer(cfg.optim),
                      stage_update_mask(trainable, cfg.stage))
    log.info("stage %s: %d trainable / %d frozen tensors", cfg.stage,
             len(trainable), len(params) - len(trainable))
    opt_state = tx.init(trainable)
    step = make_pretrain_step(model, tx, trainable)
    metrics: Dict[str, Any] = {}
    losses = []
    for _ in range(max_steps):
        batch = to_device(next(data_iter), dev)
        with timer if timer is not None else contextlib.nullcontext():
            opt_state, metrics = step(opt_state, batch)
            losses.append(float(metrics["loss"]))
    return model.state_dict(), {**{k: float(v) for k, v in metrics.items()},
                                "losses": losses}


def main(argv=None) -> None:
    from pathlib import Path

    from vla_adapter_torch.data.chat import AlignDataset, FinetuneDataset
    from vla_adapter_torch.data.collator import collate
    from vla_adapter_torch.data.image_processing import image_processor_for
    from vla_adapter_torch.data.tokenization import load_qwen_tokenizer
    from vla_adapter_torch.train.checkpoints import load_params, save_params

    cfg = parse_config(PretrainConfig, argv)
    if not cfg.data_json:
        raise SystemExit("--data_json is required")
    tok = load_qwen_tokenizer(cfg.tokenizer_dir)
    ds_cls = AlignDataset if cfg.stage == "align" else FinetuneDataset
    ds = ds_cls(cfg.data_json,
                tokenize=lambda t: tok(t, add_special_tokens=True).input_ids,
                image_processor=image_processor_for(cfg.model.vision),
                image_root=cfg.image_root,
                max_text_tokens=cfg.max_text_tokens)

    def batches():
        rng = np.random.default_rng(cfg.seed)
        while True:
            idx = rng.integers(0, len(ds), size=cfg.batch_size)
            yield collate([ds[int(i)] for i in idx])

    init_params = None
    if cfg.init_from:
        if (Path(cfg.init_from) / "config.json").exists():
            from vla_adapter_torch.weights.convert import vla_state_from_hf
            from vla_adapter_torch.weights.load import (
                load_hf_backbone_state_dict,
            )

            init_params = vla_state_from_hf(
                load_hf_backbone_state_dict(cfg.init_from), cfg.model)
        else:
            init_params = load_params(cfg.init_from)
    params, metrics = pretrain(cfg, batches(), max_steps=cfg.optim.max_steps,
                               init_params=init_params)
    out = save_params(cfg.out_dir, params)
    log.info("pretrained params saved to %s (final metrics: %s)", out, metrics)


if __name__ == "__main__":
    main()
