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
from vla_adapter_tpu.ops.attention import _attention_bwd, xla_attention
from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.attention import dot_product_attention
from vla_adapter_torch.ops.attention_kernel import (
    BWD_KERNEL_NAME,
    attention_bwd,
    attention_bwd_plan,
    attention_bwd_reference,
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


def test_backward_plan_at_the_training_shapes():
    """Kernel 1 keeps p and bf16(dp) of its warps' rows in shared memory:
    3 warps fit at the LLM's S = 640, 4 at the towers'; S past ~2300
    raises."""
    llm = attention_bwd_plan(16, 14, 2, 640, 64)
    assert llm["row_warps"] == 3 and llm["row_smem_bytes"] <= 232448
    assert llm["col_ctas"] == 16 * 2 * 10
    for shape in ((32, 16, 16, 261, 64), (32, 16, 16, 256, 72)):
        plan = attention_bwd_plan(*shape)
        assert plan["row_warps"] == 4 and plan["row_smem_bytes"] <= 232448
    with pytest.raises(ValueError, match="too long"):
        attention_bwd_plan(1, 1, 1, 4096, 64)
