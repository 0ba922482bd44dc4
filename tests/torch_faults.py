"""Deliberately wrong attention backwards (no JAX), to show that a check
of the finetune's gradients catches a faulty backward; and
:func:`scaled_gradient`, one trainable tensor's gradient scaled by its
backward.

Each has the signature of ``ops.attention_kernel.attention_bwd`` (the
forward's ``lse`` accepted and not used) and computes the vjp of
``xla_attention_reference`` by hand in fp32 with one term broken: the
rowsum(dp * p) term of ds left out, or dk and dv taken
from the first query head of each KV head's group instead of summed over
the group. Put one in place of ``ops.attention.attention_bwd`` (the
kernel path) or ``ops.attention.attention_bwd_reference`` (the plain
path) with ``monkeypatch.setattr``.
"""

import contextlib

import torch

from vla_adapter_torch.ops.attention_kernel import NEG_INF


def _attention_bwd(q, k, v, valid, dout, causal, sm_scale, d_term,
                   gqa_sum):
    b, h, s, d = q.shape
    groups = h // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf, of = q.float(), dout.float()
    kf = k.repeat_interleave(groups, dim=1).float()
    vf = v.repeat_interleave(groups, dim=1).float()
    mask = torch.ones((b, 1, s, s), dtype=torch.bool, device=q.device)
    if valid is not None:
        mask = mask & (valid != 0)[:, None, None, :]
    if causal:
        mask = mask & torch.ones(s, s, dtype=torch.bool,
                                 device=q.device).tril()
    scores = torch.where(mask, qf @ kf.transpose(-1, -2) * sm_scale,
                         NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dv = p.to(q.dtype).float().transpose(-1, -2) @ of
    dp = of @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) if d_term else p * dp
    ds = torch.where(mask, ds, 0.0)
    dq = ds @ kf * sm_scale
    dk = ds.transpose(-1, -2) @ qf * sm_scale
    if gqa_sum:
        dk, dv = (t.unflatten(1, (-1, groups)).sum(2) for t in (dk, dv))
    else:
        dk, dv = dk[:, ::groups], dv[:, ::groups]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_without_d_term(q, k, v, valid, dout, *, causal=False,
                                 sm_scale=None, lse=None):
    """ds = p * dp: the softmax's rowsum(dp * p) term left out."""
    return _attention_bwd(q, k, v, valid, dout, causal, sm_scale,
                          d_term=False, gqa_sum=True)


def attention_bwd_without_gqa_sum(q, k, v, valid, dout, *, causal=False,
                                  sm_scale=None, lse=None):
    """dk and dv of the group's first query head only, not summed."""
    return _attention_bwd(q, k, v, valid, dout, causal, sm_scale,
                          d_term=True, gqa_sum=False)


FAULTS = {"without_d_term": attention_bwd_without_d_term,
          "without_gqa_sum": attention_bwd_without_gqa_sum}


@contextlib.contextmanager
def scaled_gradient(name: str, factor: float):
    """Within the block every training state started by
    ``train.step.init_train_state`` (``finetune``'s, and chip_smoke's own
    runs') gets ``factor`` times the gradient of its tensor ``name`` (0:
    lost, 0.5: halved) from autograd, through a hook on that tensor: a
    backward that dropped or halved it."""
    from vla_adapter_torch.train import loop, step

    init = step.init_train_state

    def faulty(*args, **kw):
        state = init(*args, **kw)
        state.trainable[name].register_hook(lambda g: g * factor)
        return state

    step.init_train_state = loop.init_train_state = faulty
    try:
        yield
    finally:
        step.init_train_state = loop.init_train_state = init
