"""Discrete action tokenizer (copy of vla_adapter_tpu/data/action_tokenizer.py).

A uniform 256-bin discretizer onto the *last* 256 ids of the vocabulary
(the reference's vla/action_tokenizer.py). With the Qwen2.5 VLA-Adapter
configuration the "vocabulary" is the extended tokenizer length, the 256
added ``<|extra_i|>`` tokens included. Only the integer ``tokenizer_len``
is needed; decoding to text takes an optional decode callable.

:func:`detokenize_bin_ids` is the tensor inverse used by the discrete decode
(``models/generate.py``) and the token objective's metrics
(``train/step.py``): bin centers of the numpy tokenizer below (float64,
rounded once to float32), so it agrees with
``decode_token_ids_to_actions`` to float32 rounding. The JAX package's
``detokenize_bin_ids_jnp`` builds its bins with float32 ``jnp.linspace``,
which lands up to one float32 ulp away on some centers.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


class ActionTokenizer:
    def __init__(
        self,
        tokenizer_len: int,
        n_bins: int = 256,
        min_action: float = -1.0,
        max_action: float = 1.0,
        decode_fn: Optional[Callable[[List[int]], str]] = None,
    ):
        self.tokenizer_len = int(tokenizer_len)
        self.n_bins = n_bins
        self.min_action, self.max_action = min_action, max_action
        self.bins = np.linspace(min_action, max_action, n_bins)
        self.bin_centers = (self.bins[:-1] + self.bins[1:]) / 2.0
        self.decode_fn = decode_fn
        # ids strictly greater than this are action tokens
        self.action_token_begin_idx = self.tokenizer_len - (n_bins + 1)

    def encode_to_ids(self, action: np.ndarray) -> np.ndarray:
        """Continuous -> token ids (same shape): bin k (1-based, from
        np.digitize) maps to id tokenizer_len - k."""
        a = np.clip(action, self.min_action, self.max_action)
        disc = np.digitize(a, self.bins)
        return (self.tokenizer_len - disc).astype(np.int64)

    def __call__(self, action: np.ndarray) -> np.ndarray:
        return self.encode_to_ids(action)

    def encode_to_text(self, action: np.ndarray) -> str:
        if self.decode_fn is None:
            raise ValueError("encode_to_text needs a tokenizer decode_fn")
        return self.decode_fn(self.encode_to_ids(action).reshape(-1).tolist())

    def decode_token_ids_to_actions(self, ids: np.ndarray) -> np.ndarray:
        """Inverse map via bin centers, with the clip that folds digitize's
        inclusive upper bin onto the last center."""
        disc = self.tokenizer_len - np.asarray(ids)
        disc = np.clip(disc - 1, 0, self.bin_centers.shape[0] - 1)
        return self.bin_centers[disc]

    @property
    def vocab_size(self) -> int:
        return self.n_bins


def qwen_extended_tokenizer_len(base_len: int = 151665,
                                num_extra: int = 256) -> int:
    """len(tokenizer) after adding the <|extra_i|> tokens: Qwen2.5 ships
    151643 BPE + 22 added special tokens = 151665; +256 extras = 151921."""
    return base_len + num_extra


class VQActionTokenizer(ActionTokenizer):
    """Residual-VQ action tokenizer: codebook indices of a pretrained VQ-VAE
    on the tail of the vocabulary. ``vq_model`` has ``get_code(actions) ->
    (B, num_codes)`` and ``draw_code_forward(indices) -> (B, chunk, dim)``.
    No released configuration uses it."""

    def __init__(self, tokenizer_len: int, vq_model, n_bins: int = 256,
                 **kwargs):
        super().__init__(tokenizer_len, n_bins=n_bins, **kwargs)
        self.vq = vq_model

    def encode_to_ids(self, action: np.ndarray) -> np.ndarray:
        codes = np.asarray(self.vq.get_code(action[None]))[0]
        return (self.tokenizer_len - 1 - codes).astype(np.int64)

    def decode_token_ids_to_actions(self, ids: np.ndarray) -> np.ndarray:
        codes = self.tokenizer_len - 1 - np.asarray(ids)
        return np.asarray(self.vq.draw_code_forward(codes[None]))[0]


ACTION_TOKENIZERS = {
    "uniform": ActionTokenizer,
    "vq": VQActionTokenizer,
}


def bin_centers(n_bins: int = 256, device=None) -> torch.Tensor:
    """(n_bins - 1,) float32 bin centers over [-1, 1]."""
    bins = np.linspace(-1.0, 1.0, n_bins)
    centers = ((bins[:-1] + bins[1:]) / 2.0).astype(np.float32)
    return torch.from_numpy(centers).to(device)


def detokenize_bin_ids(token_ids: torch.Tensor, tokenizer_len: int,
                       n_bins: int = 256) -> torch.Tensor:
    """Token ids (any shape) -> float32 actions in [-1, 1] by bin centers,
    clamped as ``decode_token_ids_to_actions`` clamps."""
    centers = bin_centers(n_bins, token_ids.device)
    disc = (tokenizer_len - token_ids.long() - 1).clamp(0, n_bins - 2)
    return centers[disc]
