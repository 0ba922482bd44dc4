"""Decoding beyond L1 regression (counterpart of
vla_adapter_tpu/models/generate.py).

* :func:`discrete_actions_from_logits`: the parallel discrete decode. One
  bidirectional pass gives logits for every action slot; the chunk is
  argmax-ed in one step, reading each slot's next-token prediction (the
  slice starts one position before the action block).
* :func:`greedy_generate`: autoregressive decode with a full recompute per
  step over a pre-padded buffer, per-sequence validity and a causal mask
  (ragged prompts), for the legacy OpenVLA path and base-VLM text.
* :func:`greedy_generate_cached`: one prefill that returns the KV cache,
  then one ``Qwen2Decode`` step per token (uniform prompt length). On the
  card the step runs as one captured CUDA graph per (backend, batch,
  buffer length, EOS id, temperature), replayed once per token
  (``infer/graph.py:GraphedDecode``); token choice, the done flags and the
  buffer write stay on the device.
* :func:`predict_action_autoregressive`: the native OpenVLA action path,
  ``action_dim`` greedy tokens from a ``PrismaticVLM``, detokenized.

EOS and ``done`` follow the JAX package: a sequence stops writing after it
emits EOS (later slots keep their pad); the cached loop runs every step.
``temperature > 0`` with a ``generator`` samples (Gumbel-max over
``logits / temperature``, the noise drawn from the caller's
``torch.Generator``, the role of the JAX package's PRNG key); otherwise
greedy, the first maximum as ``jnp.argmax`` takes it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vla_adapter_torch.data.action_tokenizer import detokenize_bin_ids
from vla_adapter_torch.models.qwen2 import Qwen2Decode


def discrete_actions_from_logits(
    logits: torch.Tensor,
    prompt_len: torch.Tensor,
    num_actions_chunk: int,
    action_dim: int,
    tokenizer_len: int,
    n_bins: int = 256,
) -> torch.Tensor:
    """logits (B, T_text, V) in text coordinates (the VLA's ``logits``) ->
    normalized actions (B, chunk, action_dim), float32."""
    n = num_actions_chunk * action_dim
    start = prompt_len.long().to(logits.device) - 1
    idx = start[:, None] + torch.arange(n, device=logits.device)[None, :]
    sliced = torch.gather(
        logits, 1, idx[:, :, None].expand(-1, -1, logits.shape[-1]))
    token_ids = torch.argmax(sliced, dim=-1)
    acts = detokenize_bin_ids(token_ids, tokenizer_len, n_bins)
    return acts.reshape(-1, num_actions_chunk, action_dim)


def _sampling(temperature: float, generator) -> bool:
    return temperature > 0 and generator is not None


def _pick(logits: torch.Tensor, temperature: float,
          noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Greedy, or Gumbel-max with ``noise`` ~ Exp(1) of logits' shape."""
    if noise is None:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits.float() / temperature - torch.log(noise),
                        dim=-1)


def _noise(shape, generator, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device) \
        .exponential_(generator=generator)


@torch.inference_mode()
def greedy_generate(
    model,
    input_ids: torch.Tensor,
    prompt_len: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Causal decode on a Qwen2Model or PhiModel by full recompute.

    input_ids (B, T) pre-padded with T >= max(prompt_len) + max_new_tokens;
    prompt_len (B,). Returns the filled buffer (a new tensor). Each step
    reads the logits at each sequence's last valid position."""
    dev = input_ids.device
    ids = input_ids.clone()
    b, t = ids.shape
    rows = torch.arange(b, device=dev)
    plen = prompt_len.long().to(dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    sample = _sampling(temperature, generator)
    for i in range(max_new_tokens):
        pos = plen + i
        valid = (torch.arange(t, device=dev)[None, :] < pos[:, None]).to(
            torch.int32)
        hidden = model(input_ids=ids, valid=valid, causal=True)[
            "last_hidden_state"]
        last = model.lm_head(hidden[rows, pos - 1])
        noise = _noise(last.shape, generator, dev) if sample else None
        tok = _pick(last, temperature, noise).to(ids.dtype)
        ids[rows, pos] = torch.where(done, ids[rows, pos], tok)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
    return ids


def _backend(rt) -> str:
    if not rt.weights_int8:
        return "bf16" if rt.dtype == torch.bfloat16 else str(rt.dtype)
    return rt.w8a8_impl if rt.act_int8 else "int8"


def decode_step_fn(decoder: Qwen2Decode, eos_token_id: Optional[int],
                   temperature: float):
    """One step of the cached loop over a state dict (``ids`` (B, T),
    ``k``/``v`` (L, B, T, Hkv, Dh), ``logits`` (B, V), ``done`` (B,),
    ``pos`` (1,) long and, when sampling, ``noise`` (B, V)), all updated in
    place: pick the token from the logits, write it at pos where not done,
    decode it into the next logits, update done, advance pos."""

    def step(s: Dict[str, torch.Tensor]) -> None:
        ids, pos = s["ids"], s["pos"]
        tok = _pick(s["logits"], temperature, s.get("noise")).to(ids.dtype)
        cur = ids.index_select(1, pos)[:, 0]
        ids.index_copy_(1, pos, torch.where(s["done"], cur, tok)[:, None])
        logits, _ = decoder(tok[:, None], (s["k"], s["v"]), pos)
        s["logits"].copy_(logits)
        if eos_token_id is not None:
            s["done"] |= tok == eos_token_id
        pos += 1

    return step


def prefill_state(model, input_ids: torch.Tensor, prompt_len: int
                  ) -> Dict[str, torch.Tensor]:
    """The cached loop's state after the prefill: the prompt (uniform
    length, all valid, causal) through ``model`` with ``return_kv``, the
    cache zero-padded to the buffer's length, the logits of the last
    prompt position, no sequence done, pos = prompt_len (see
    :func:`decode_step_fn`)."""
    if not hasattr(model, "decode_step"):
        raise NotImplementedError(
            f"{type(model).__name__} has no cached decode (the JAX package "
            "has none for Phi): use greedy_generate")
    dev = input_ids.device
    b, total = input_ids.shape
    out = model(input_ids=input_ids[:, :prompt_len],
                valid=torch.ones((b, prompt_len), dtype=torch.int32,
                                 device=dev),
                causal=True, return_kv=True)
    pad = total - prompt_len
    k, v = (torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
            for c in out["kv_cache"])
    return {"ids": input_ids.clone(), "k": k, "v": v,
            "logits": model.lm_head(out["last_hidden_state"][:, -1]),
            "done": torch.zeros(b, dtype=torch.bool, device=dev),
            "pos": torch.full((1,), prompt_len, dtype=torch.long,
                              device=dev)}


def decode_key(model, batch: int, total: int, eos_token_id, temperature):
    """The key of the decode step's CUDA graph: (backend, batch, buffer
    length, EOS id, temperature); the last two are baked into the step."""
    return (_backend(model.rt), batch, total, eos_token_id, temperature)


@torch.inference_mode()
def greedy_generate_cached(
    model,
    input_ids: torch.Tensor,
    prompt_len: int,
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    cuda_graph: Optional[bool] = None,
) -> torch.Tensor:
    """KV-cached decode: input_ids (B, T) with a UNIFORM prompt length
    ``prompt_len`` (int), T >= prompt_len + max_new_tokens. Returns the
    filled buffer (a new tensor).

    cuda_graph: None (on the card yes, on the CPU no), True (the CPU
    raises) or False (the eager loop, step by step)."""
    decoder = Qwen2Decode(model)
    dev = input_ids.device
    on_card = dev.type == "cuda"
    if cuda_graph and not on_card:
        raise ValueError(f"cuda_graph=True needs a CUDA device, not {dev}")
    cuda_graph = on_card if cuda_graph is None else cuda_graph
    b, total = input_ids.shape
    if total < prompt_len + max_new_tokens:
        raise ValueError(f"buffer of {total} < prompt {prompt_len} + "
                         f"{max_new_tokens} new tokens")
    state = prefill_state(model, input_ids, prompt_len)
    sample = _sampling(temperature, generator)
    temperature = temperature if sample else 0.0
    before_step = None
    if sample:
        state["noise"] = torch.zeros(state["logits"].shape,
                                     dtype=torch.float32, device=dev)

        def before_step(s):
            s["noise"].exponential_(generator=generator)

    step = decode_step_fn(decoder, eos_token_id, temperature)
    if cuda_graph:
        from vla_adapter_torch.infer.graph import decode_graphs

        decode_graphs(model, dev)(
            decode_key(model, b, total, eos_token_id, temperature), step,
            state, max_new_tokens, before_step)
    else:
        for _ in range(max_new_tokens):
            if before_step is not None:
                before_step(state)
            step(state)
    return state["ids"]


@torch.inference_mode()
def predict_action_autoregressive(
    vlm,
    input_ids: torch.Tensor,
    text_valid: torch.Tensor,
    pixel_values: torch.Tensor,
    prompt_len: torch.Tensor,
    action_tokenizer,
    action_dim: int,
    return_token_ids: bool = False,
):
    """``action_dim`` greedy action tokens from a PrismaticVLM (causal,
    the token objective), each from a full forward, detokenized by bin
    centers on the host: (B, action_dim); with ``return_token_ids`` also
    the tokens (B, action_dim)."""
    ids, valid = input_ids.clone(), text_valid.clone()
    dev = ids.device
    b = ids.shape[0]
    rows = torch.arange(b, device=dev)
    plen = prompt_len.long().to(dev)
    toks = []
    for i in range(action_dim):
        logits = vlm(ids, valid, pixel_values, compute_logits=True)["logits"]
        pos = plen + i
        tok = torch.argmax(logits[rows, pos - 1], dim=-1).to(ids.dtype)
        ids[rows, pos] = tok
        valid[rows, pos] = 1
        toks.append(tok)
    token_ids = torch.stack(toks, dim=1).cpu().numpy()
    actions = action_tokenizer.decode_token_ids_to_actions(token_ids)
    return (actions, token_ids) if return_token_ids else actions
