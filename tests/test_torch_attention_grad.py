"""The attention backward (B1-bwd's plain version and the autograd
wrapper) against the JAX package's backward, on the CPU.

The JAX package trains through ``_attention_pallas_trainable``, whose
backward is ``jax.vjp(xla_attention)``; the port's plain backward is
autograd through ``xla_attention_reference``, its twin. In fp32 the two
agree to fp32 summation order (atol = rtol = 1e-5, the JAX package's own
tolerance for its kernel against XLA), on the forward tests' shapes and
on rows with no valid key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attention import CASES, _inputs
from vla_adapter_tpu.ops.attention import (
    NEG_INF,
    _attention_bwd,
    _expand_kv,
    xla_attention,
)
from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.attention import dot_product_attention
from vla_adapter_torch.ops.attention_kernel import (
    BWD_KERNEL_NAME,
    attention_bwd,
    attention_bwd_d_reference,
    attention_bwd_plan,
    attention_bwd_reference,
    attention_reference,
    xla_attention_reference,
)

ATOL = RTOL = 1e-5

# the forward tests' shapes, and causal rows with no valid key (rows 0-4:
# keys 0-4 padded) at a length that is not a multiple of 16
GRAD_CASES = dict(CASES, empty_rows_causal=(2, 14, 2, 37, 72, True, True))


def _grad_inputs(name):
    b, h, hkv, s, d, padded, causal = GRAD_CASES[name]
    q, k, v, valid = _inputs(b, h, hkv, s, d, padded, seed=3)
    if name == "empty_rows_causal":
        valid[1, :5] = 0
    dout = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    return q, k, v, valid, dout, causal


def _jax_grads(q, k, v, valid, dout, causal, sm_scale):
    """jax.vjp(xla_attention) in the JAX layout (B, S, H, D), returned in
    the port's (B, H, S, D)."""
    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    _, vjp = jax.vjp(lambda q_, k_, v_: xla_attention(
        q_, k_, v_, jnp.asarray(valid), causal=causal, sm_scale=sm_scale),
        t(q), t(k), t(v))
    return [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(t(dout))]


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_plain_backward_matches_jax_vjp_fp32(name):
    q, k, v, valid, dout, causal = _grad_inputs(name)
    sm_scale = q.shape[-1] ** -0.5
    want = _jax_grads(q, k, v, valid, dout, causal, sm_scale)
    got = attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid, dout)),
        causal=causal, sm_scale=sm_scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["bidir_padded", "empty_rows_causal"])
def test_plain_twin_forward_matches_xla_attention(name):
    q, k, v, valid, _, causal = _grad_inputs(name)
    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    want = np.asarray(xla_attention(t(q), t(k), t(v), jnp.asarray(valid),
                                    causal=causal, sm_scale=0.125))
    got = xla_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid)), causal=causal,
        sm_scale=0.125)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3), want,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("name", ["gqa_14_2", "empty_rows_causal"])
def test_autograd_wrapper_equals_plain_backward(name, impl):
    """dot_product_attention under autograd on CPU tensors: the forward of
    the non-autograd call, and exactly the plain backward's gradients (in
    the model's (B, S, H, D) layout)."""
    q, k, v, valid, dout, causal = _grad_inputs(name)
    bshd = lambda x: torch.from_numpy(x.transpose(0, 2, 1, 3).copy())  # noqa
    qt, kt, vt = (bshd(x).requires_grad_(True) for x in (q, k, v))
    vt_ = torch.from_numpy(valid)
    out = dot_product_attention(qt, kt, vt, vt_, causal=causal, impl=impl)
    with torch.no_grad():
        ref_out = dot_product_attention(qt, kt, vt, vt_, causal=causal,
                                        impl=impl)
    assert torch.equal(out, ref_out)
    grads = torch.autograd.grad(out, (qt, kt, vt), bshd(dout))
    want = attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid, dout)),
        causal=causal)
    for g, w in zip(grads, want):
        assert g.shape == w.transpose(1, 2).shape
        assert torch.equal(g, w.transpose(1, 2))


def test_matches_the_jax_custom_vjp_backward():
    """The function B1-bwd replaces: the backward of the JAX package's
    custom-VJP attention, ``_attention_bwd``, on the residuals (q, k, v,
    valid)."""
    q, k, v, valid, dout, causal = _grad_inputs("bidir_padded")
    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    grads = _attention_bwd(causal, 0.25,
                           (t(q), t(k), t(v), jnp.asarray(valid)), t(dout))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in grads[:3]]
    got = attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid, dout)),
        causal=causal, sm_scale=0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


def test_attention_bwd_on_cpu_is_the_plain_version():
    q, k, v, valid, dout, causal = _grad_inputs("causal")
    args = [torch.from_numpy(x) for x in (q, k, v, valid, dout)]
    cuda_lib.reset_launches()
    got = attention_bwd(*args, causal=causal)
    want = attention_bwd_reference(*args, causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_lib.LAUNCHES[BWD_KERNEL_NAME] == 0


def _jax_masked_scores(q, k, valid, causal, sm_scale):
    """xla_attention's fp32 scores after its select mask, (B, H, S, S),
    from (B, H, S, D) numpy inputs."""
    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    qj, kj = t(q), _expand_kv(t(k), q.shape[1] // k.shape[1])
    s = jnp.einsum("bqhd,bkhd->bhqk", qj, kj,
                   preferred_element_type=jnp.float32) * sm_scale
    seq = q.shape[2]
    mask = jnp.asarray(valid).astype(jnp.bool_)[:, None, None, :]
    if causal:
        mask = mask & (jnp.arange(seq)[None, :] <= jnp.arange(seq)[:, None])
    return jnp.where(mask, s, NEG_INF)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_plain_forward_lse_matches_jax_logsumexp(name):
    """The row log-sum-exp the plain forward returns for the backward
    (about -2e9 for a row with no valid key) against jax.nn.logsumexp of
    xla_attention's masked fp32 scores."""
    q, k, v, valid, _, causal = _grad_inputs(name)
    sm_scale = q.shape[-1] ** -0.5
    want = np.asarray(jax.nn.logsumexp(
        _jax_masked_scores(q, k, valid, causal, sm_scale), axis=-1))
    out, lse = attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid)), causal=causal,
        sm_scale=sm_scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.equal(out, attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid)), causal=causal,
        sm_scale=sm_scale))
    np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=RTOL)


def _jax_vjp_d(q, k, v, valid, dout, causal, sm_scale):
    """The D inside jax.vjp(xla_attention): rowsum(dp * p), dp the
    gradient at xla_attention's bf16-cast probabilities (the identity in
    fp32), p its softmax."""
    p = jax.nn.softmax(_jax_masked_scores(q, k, valid, causal, sm_scale),
                       axis=-1)
    vj = _expand_kv(jnp.asarray(v.transpose(0, 2, 1, 3)),
                    q.shape[1] // k.shape[1])
    _, vjp = jax.vjp(lambda p_: jnp.einsum(
        "bhqk,bkhd->bqhd", p_.astype(jnp.float32), vj,
        preferred_element_type=jnp.float32), p)
    (dp,) = vjp(jnp.asarray(dout.transpose(0, 2, 1, 3)))
    return np.asarray((dp * p).sum(-1))


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_row_statistic_d_matches_the_jax_vjp(name):
    """D, the term the softmax's vjp subtracts, three ways in fp32: the
    port's plain version of kernel 1 (sum p * dp, as the vjp forms it) and
    FlashAttention's identity rowsum(dO * out) from the plain forward's
    pieces, each against the D inside the JAX vjp (rows with no valid key
    included: p = 1/S there, and out the mean of v)."""
    q, k, v, valid, dout, causal = _grad_inputs(name)
    sm_scale = q.shape[-1] ** -0.5
    want = _jax_vjp_d(q, k, v, valid, dout, causal, sm_scale)
    args = [torch.from_numpy(x) for x in (q, k, v, valid, dout)]
    got = attention_bwd_d_reference(*args, causal=causal, sm_scale=sm_scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    out = xla_attention_reference(*args[:4], causal=causal,
                                  sm_scale=sm_scale)
    identity = (args[4] * out).sum(-1).numpy()
    np.testing.assert_allclose(identity, want, atol=ATOL, rtol=RTOL)


def test_backward_plan_at_the_training_shapes():
    """No per-row storage: the same CTA at every S (two consumer
    warpgroups of 64 rows, a 4-stage TMA ring, one CTA an SM), 128-byte
    swizzled tiles at D = 64 and 32-byte ones at D = 72 (padded to 80); the
    LLM's 70-item dk/dv stream split between the warpgroups of a CTA, the
    towers' 4-5 items shared; S = 4096 and 8192 plan without a raise."""
    llm = attention_bwd_plan(16, 14, 2, 640, 64)
    assert (llm["chunk"], llm["swizzle_bytes"], llm["stages"]) == (64, 128, 4)
    assert llm["warpgroups"] == 2 and llm["ctas_per_sm"] == 1
    assert llm["d_ctas"] == llm["dq_ctas"] == 16 * 2 * 35
    assert llm["dkdv_items"] == 70 and llm["dkdv_split"]
    assert llm["dkdv_ctas"] == 16 * 2 * 10
    dino = attention_bwd_plan(32, 16, 16, 261, 64)
    assert dino["dq_ctas"] == dino["dkdv_ctas"] == 32 * 16 * 3
    assert dino["dkdv_items"] == 5 and not dino["dkdv_split"]
    siglip = attention_bwd_plan(32, 16, 16, 256, 72)
    assert (siglip["chunk"], siglip["swizzle_bytes"]) == (16, 32)
    assert siglip["dq_ctas"] == siglip["dkdv_ctas"] == 32 * 16 * 2
    for plan in (llm, dino, siglip):
        assert plan["smem_bytes"] <= 232448
    for seq in (4096, 8192):
        plan = attention_bwd_plan(1, 14, 2, seq, 64)
        assert plan["smem_bytes"] <= 232448 and plan["ctas_per_sm"] == 1
        assert plan["dkdv_items"] == 7 * seq // 64
