"""The port's causal language path against the JAX package's, on the CPU.

RoPE at given positions and the attention masks; the Qwen2 forward's
logits and KV cache; the cached decode step (``Qwen2Decode``); greedy
generation uncached (ragged prompts, EOS) and cached, token for token,
also under w8a8 "fused" (the JAX package's own cached-vs-uncached check,
with ``act_int8_min_dim=1``); the discrete-action decode and the bin
inverse; the autoregressive action path on the tiny PrismaticVLM;
sampling; the refusals; the REPL and its config. Weights come from the
Flax init, perturbed, carried with ``from_jax_params``.

Tolerances: fp32 summation order through a few layers, 1e-4. Masks are
exact; RoPE tables at given positions agree to two float32 ulps (XLA's
and PyTorch's cos and sin of the same fp32 argument differ by an ulp on
some inputs), their bf16 casts to one bf16 ulp. Generated tokens are identical. The bin centers
agree to one float32 ulp (the JAX package builds them with float32
``jnp.linspace``, the port from the numpy tokenizer's float64 bins).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_tpu.core.config as jc
from tests.test_torch_vlm import JCFG, TCFG, jax_vlm_params, vlm_inputs
from vla_adapter_tpu.core.cli import parse_config as jparse
from vla_adapter_tpu.data import action_tokenizer as jat
from vla_adapter_tpu.infer import generate_repl as jrepl
from vla_adapter_tpu.models import generate as jgen
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JRT
from vla_adapter_tpu.models.layers import Runtime as JRuntime
from vla_adapter_tpu.models.quantize import quantize_params, split_qstack
from vla_adapter_tpu.models.qwen2 import Qwen2Decode as JDecode
from vla_adapter_tpu.models.qwen2 import Qwen2Model as JQwen2
from vla_adapter_tpu.models.vlm import PrismaticVLM as JVLM
from vla_adapter_tpu.ops import masks as jmasks
from vla_adapter_tpu.ops import rope as jrope
from vla_adapter_torch.core.cli import parse_config as tparse
from vla_adapter_torch.data import action_tokenizer as tat
from vla_adapter_torch.infer import generate_repl as trepl
from vla_adapter_torch.models import generate as tgen
from vla_adapter_torch.models.layers import FP32_RUNTIME as TRT
from vla_adapter_torch.models.layers import Runtime
from vla_adapter_torch.models.phi import PhiModel
from vla_adapter_torch.models.qwen2 import Qwen2Decode, Qwen2Model
from vla_adapter_torch.models.vlm import PrismaticVLM
from vla_adapter_torch.ops import masks as tmasks
from vla_adapter_torch.ops import rope as trope
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
LLM = dict(vocab_size=128, hidden_size=64, num_layers=3, num_heads=4,
           num_kv_heads=2, intermediate_size=128, head_dim=16)
JLLM, TLLM = jc.Qwen2Config(**LLM), tc.Qwen2Config(**LLM)
PROMPT, NEW = 7, 6


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def llm_params():
    ids = jnp.ones((1, PROMPT), jnp.int32)
    params = JQwen2(JLLM, JRT).init(jax.random.key(1), input_ids=ids,
                                    valid=jnp.ones_like(ids), causal=True)
    return _perturb(params["params"], 0)


def _port_llm(params, rt=TRT):
    model = Qwen2Model(TLLM, rt, device="cpu")
    model.load_state_dict(from_jax_params(params, TLLM), strict=True)
    return model.eval()


def _buffer(batch=2, seed=3):
    rng = np.random.default_rng(seed)
    buf = np.zeros((batch, PROMPT + NEW + 2), np.int32)
    buf[:, :PROMPT] = rng.integers(1, LLM["vocab_size"], (batch, PROMPT))
    return buf


# --- RoPE and masks -------------------------------------------------------

def test_rope_at_positions_matches_jax():
    pos = np.asarray([0, 3, 17, 128, 4095], np.int32)
    for dim, theta in ((16, 1e6), (32, 1e4)):
        cj, sj = jrope.rope_cos_sin(5, dim, theta,
                                    positions=jnp.asarray(pos))
        ct, st = trope.rope_cos_sin(5, dim, theta,
                                    positions=torch.from_numpy(pos))
        _close(ct, cj, atol=2.4e-7, rtol=0)
        _close(st, sj, atol=2.4e-7, rtol=0)
    cj, _ = jrope.rope_cos_sin(9, 16, 1e6, dtype=jnp.bfloat16,
                               positions=jnp.asarray(pos))
    ct, _ = trope.rope_cos_sin(9, 16, 1e6, dtype=torch.bfloat16,
                               positions=torch.from_numpy(pos))
    assert ct.dtype == torch.bfloat16 and tuple(ct.shape) == (5, 16)
    _close(ct, np.asarray(cj, np.float32), atol=2 ** -8, rtol=0)


@pytest.mark.parametrize("mode", ["bidirectional", "causal", "prefix_int",
                                  "prefix_rows", "no_valid_causal"])
def test_masks_match_jax(mode):
    valid = np.ones((3, 9), np.int32)
    valid[1, 6:] = 0
    valid[2, 2:] = 0
    kw, v = {}, valid
    if mode.startswith("prefix"):
        kw["suffix_start"] = 4 if mode == "prefix_int" else np.asarray(
            [3, 5, 8])
        mode_name = "prefix_bidir"
    elif mode == "no_valid_causal":
        v, mode_name = None, "causal"
    else:
        mode_name = mode
    want = jmasks.build_attention_mask(
        mode_name, None if v is None else jnp.asarray(v), 9,
        **{k: jnp.asarray(x) for k, x in kw.items()})
    got = tmasks.build_attention_mask(
        mode_name, None if v is None else torch.from_numpy(v), 9,
        **{k: torch.as_tensor(x) for k, x in kw.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tmasks.combine_masks(None, tmasks.causal_mask(9),
                             tmasks.padding_mask(torch.from_numpy(valid))
                             ).numpy(),
        np.asarray(jmasks.combine_masks(None, jmasks.causal_mask(9),
                                        jmasks.padding_mask(
                                            jnp.asarray(valid)))))
    with pytest.raises(ValueError):
        tmasks.build_attention_mask("prefix_bidir", None, 9)


# --- the forward's logits and cache, the decode step -------------------------

@pytest.mark.parametrize("positions", [False, True])
def test_qwen2_logits_and_kv_match_jax(llm_params, positions):
    buf = _buffer()[:, :PROMPT]
    valid = np.ones_like(buf)
    valid[1, 5:] = 0
    pos = np.asarray([2, 3, 5, 8, 13, 21, 34], np.int32) if positions else None
    want = JQwen2(JLLM, JRT).apply(
        {"params": llm_params}, input_ids=jnp.asarray(buf),
        valid=jnp.asarray(valid), causal=True, compute_logits=True,
        return_kv=True, output_hidden_states=True,
        positions=None if pos is None else jnp.asarray(pos))
    with torch.no_grad():
        got = _port_llm(llm_params)(
            input_ids=torch.from_numpy(buf), valid=torch.from_numpy(valid),
            causal=True, compute_logits=True, return_kv=True,
            output_hidden_states=True,
            positions=None if pos is None else torch.from_numpy(pos))
    rows = valid.astype(bool)
    _close(got["logits"].numpy()[rows], np.asarray(want["logits"])[rows])
    _close(got["hidden_states"].numpy().transpose(0, 2, 1, 3)[rows],
           np.asarray(want["hidden_states"]).transpose(0, 2, 1, 3)[rows])
    for g, w in zip(got["kv_cache"], want["kv_cache"]):
        assert tuple(g.shape) == (3, 2, PROMPT, 2, 16)
        _close(g, w)


def test_decode_steps_match_jax(llm_params):
    """Three cached steps from a prefill: logits and both caches."""
    buf = _buffer()
    total = buf.shape[1]
    jm = JQwen2(JLLM, JRT)
    out = jm.apply({"params": llm_params}, input_ids=jnp.asarray(
        buf[:, :PROMPT]), valid=jnp.ones((2, PROMPT), jnp.int32),
        causal=True, return_kv=True)
    pad = ((0, 0), (0, 0), (0, total - PROMPT), (0, 0), (0, 0))
    kv_j = tuple(jnp.pad(c, pad) for c in out["kv_cache"])
    kv_t = tuple(torch.from_numpy(np.array(c)) for c in kv_j)
    decoder = Qwen2Decode(_port_llm(llm_params))
    toks = np.asarray([[5, 9], [77, 3], [120, 120]], np.int32)
    for i, tok in enumerate(toks):
        pos = PROMPT + i
        lj, kv_j = JDecode(JLLM, JRT).apply({"params": llm_params},
                                            jnp.asarray(tok[:, None]), kv_j,
                                            pos)
        with torch.no_grad():
            lt, kv_t = decoder(torch.from_numpy(tok[:, None]), kv_t,
                               torch.tensor([pos]))
        assert tuple(lt.shape) == (2, LLM["vocab_size"])
        _close(lt, lj)
        for g, w in zip(kv_t, kv_j):
            _close(g, w)


# --- greedy generation -------------------------------------------------------

@pytest.mark.parametrize("eos", [None, "first"])
def test_greedy_generate_matches_jax(llm_params, eos):
    buf = _buffer()
    plen = np.asarray([PROMPT, 4], np.int32)
    buf[1, 4:] = 0
    model = _port_llm(llm_params)
    eos_id = None
    if eos:  # the token sequence 0 emits first, so that it stops early
        first = tgen.greedy_generate(model, torch.from_numpy(buf),
                                     torch.from_numpy(plen), 1)
        eos_id = int(first[0, PROMPT])
    want = np.asarray(jgen.greedy_generate(
        JQwen2(JLLM, JRT), llm_params, jnp.asarray(buf), jnp.asarray(plen),
        NEW, eos_token_id=eos_id))
    got = tgen.greedy_generate(model, torch.from_numpy(buf),
                               torch.from_numpy(plen), NEW,
                               eos_token_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos:
        assert (got[0, PROMPT + 1:] == 0).all()


@pytest.mark.parametrize("eos", [None, "first"])
def test_greedy_generate_cached_matches_jax(llm_params, eos):
    buf = _buffer(batch=3)
    model = _port_llm(llm_params)
    eos_id = None
    if eos:
        first = tgen.greedy_generate_cached(model, torch.from_numpy(buf),
                                            PROMPT, 1)
        eos_id = int(first[1, PROMPT])
    want = np.asarray(jgen.greedy_generate_cached(
        JQwen2(JLLM, JRT), llm_params, jnp.asarray(buf), PROMPT, NEW,
        eos_token_id=eos_id))
    got = tgen.greedy_generate_cached(model, torch.from_numpy(buf), PROMPT,
                                      NEW, eos_token_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    uncached = tgen.greedy_generate(model, torch.from_numpy(buf),
                                    torch.full((3,), PROMPT), NEW,
                                    eos_token_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), uncached.numpy())


def test_w8a8_fused_cached_decode_matches_jax(llm_params):
    """The JAX package's check under the split params/qstack layout
    (tests/test_quantize.py): cached equals uncached under w8a8 "fused"
    with act_int8_min_dim=1; here both also equal the JAX package's."""
    jrt = dataclasses.replace(JRuntime(dtype=jnp.float32,
                                       param_dtype=jnp.float32,
                                       attn_impl="xla"),
                              weights_int8=True, act_int8=True,
                              act_int8_min_dim=1, w8a8_impl="fused")
    ids0 = jnp.ones((2, PROMPT), jnp.int32)
    model_j = JQwen2(JLLM, jrt)
    shapes = jax.eval_shape(lambda k: model_j.init(
        k, input_ids=ids0, valid=jnp.ones_like(ids0), causal=True),
        jax.random.key(0))
    quant = quantize_params(llm_params)
    variables = dict(zip(("params", "qstack"),
                         split_qstack(quant, shapes["qstack"])))
    buf = _buffer()
    want_u = np.asarray(jgen.greedy_generate(
        model_j, variables, jnp.asarray(buf), jnp.full((2,), PROMPT), NEW))
    want_c = np.asarray(jgen.greedy_generate_cached(
        model_j, variables, jnp.asarray(buf), PROMPT, NEW))
    np.testing.assert_array_equal(want_u, want_c)
    rt = dataclasses.replace(TRT, weights_int8=True, act_int8=True,
                             act_int8_min_dim=1, w8a8_impl="fused")
    model = Qwen2Model(TLLM, rt, device="cpu")
    model.load_state_dict(from_jax_params(quant, TLLM), strict=True)
    got_c = tgen.greedy_generate_cached(model.eval(), torch.from_numpy(buf),
                                        PROMPT, NEW)
    got_u = tgen.greedy_generate(model, torch.from_numpy(buf),
                                 torch.full((2,), PROMPT), NEW)
    np.testing.assert_array_equal(got_c.numpy(), got_u.numpy())
    np.testing.assert_array_equal(got_c.numpy(), want_c)


# --- discrete and autoregressive actions --------------------------------------

def test_detokenize_and_discrete_actions_match_jax():
    rng = np.random.default_rng(4)
    n = 2 * 7
    ids = rng.integers(200, 530, size=(3, 40))
    want = np.asarray(jat.detokenize_bin_ids_jnp(jnp.asarray(ids), 512))
    got = tat.detokenize_bin_ids(torch.from_numpy(ids), 512)
    _close(got, want, atol=1.2e-7, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), jat.ActionTokenizer(512).decode_token_ids_to_actions(
            ids).astype(np.float32), rtol=0, atol=0)
    logits = rng.normal(size=(3, 40, 512)).astype(np.float32)
    plen = np.asarray([3, 10, 20], np.int32)
    want = np.asarray(jgen.discrete_actions_from_logits(
        jnp.asarray(logits), jnp.asarray(plen), 2, 7, 512))
    got = tgen.discrete_actions_from_logits(
        torch.from_numpy(logits), torch.from_numpy(plen), 2, 7, 512)
    assert tuple(got.shape) == (3, 2, 7)
    _close(got, want, atol=1.2e-7, rtol=0)
    for k in range(3):  # the same argmax positions as the JAX slice
        assert np.all(np.abs(got[k].numpy().reshape(-1)
                             - want[k].reshape(-1)) < 1e-6), k
    assert n == 14
    tok = tat.ActionTokenizer(tat.qwen_extended_tokenizer_len())
    jtok = jat.ActionTokenizer(jat.qwen_extended_tokenizer_len())
    acts = rng.uniform(-1.2, 1.2, size=(5, 7))
    np.testing.assert_array_equal(tok(acts), jtok(acts))
    assert tok.action_token_begin_idx == jtok.action_token_begin_idx


def test_predict_action_autoregressive_matches_jax():
    params = jax_vlm_params(JCFG, seed=5)
    x = vlm_inputs(JCFG, batch=2, seed=6)
    plen = np.asarray([5, 9], np.int32)
    valid = np.zeros_like(x["input_ids"])
    for i, p in enumerate(plen):
        valid[i, :p] = 1
    tok_j = jat.ActionTokenizer(JCFG.llm.vocab_size)
    want = jgen.predict_action_autoregressive(
        JVLM(JCFG, JRT), params, jnp.asarray(x["input_ids"]),
        jnp.asarray(valid), jnp.asarray(x["pixel_values"]),
        jnp.asarray(plen), tok_j, 7)
    vlm = PrismaticVLM(TCFG, TRT, device="cpu")
    vlm.load_state_dict(from_jax_params(params, TCFG), strict=True)
    got = tgen.predict_action_autoregressive(
        vlm.eval(), torch.from_numpy(x["input_ids"]),
        torch.from_numpy(valid), torch.from_numpy(x["pixel_values"]),
        torch.from_numpy(plen), tat.ActionTokenizer(TCFG.llm.vocab_size), 7)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got, want)


# --- sampling and refusals ----------------------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_sampling_follows_the_generator(llm_params, cached):
    model = _port_llm(llm_params)
    buf = torch.from_numpy(_buffer())

    def run(temperature, seed):
        gen = torch.Generator().manual_seed(seed)
        if cached:
            return tgen.greedy_generate_cached(model, buf, PROMPT, NEW,
                                               temperature=temperature,
                                               generator=gen)
        return tgen.greedy_generate(model, buf, torch.full((2,), PROMPT),
                                    NEW, temperature=temperature,
                                    generator=gen)

    a, b, c = run(1.5, 0), run(1.5, 0), run(1.5, 1)
    assert torch.equal(a, b)
    assert not torch.equal(a[:, PROMPT:], c[:, PROMPT:])
    greedy = tgen.greedy_generate(model, buf, torch.full((2,), PROMPT), NEW)
    assert torch.equal(run(1e-6, 2), greedy)
    assert torch.equal(run(0.0, 3), greedy)


def test_mega_and_phi_decode_raise(llm_params):
    rt = dataclasses.replace(TRT, weights_int8=True, act_int8=True,
                             act_int8_min_dim=1, w8a8_impl="mega")
    mega = Qwen2Model(TLLM, rt, device="meta")
    with pytest.raises(NotImplementedError, match="mega"):
        Qwen2Decode(mega)
    with pytest.raises(NotImplementedError, match="mega"):
        mega.layers[0].decode_step(None, None, None, None, None, None)
    phi = PhiModel(tc.PhiConfig(vocab_size=64, hidden_size=32, num_layers=1,
                                num_heads=2, intermediate_size=64,
                                head_dim=16), TRT, device="cpu")
    with pytest.raises(NotImplementedError, match="Phi"):
        tgen.greedy_generate_cached(phi, torch.ones(1, 4, dtype=torch.long),
                                    2, 1)
    with pytest.raises(ValueError, match="cuda_graph"):
        tgen.greedy_generate_cached(_port_llm(llm_params),
                                    torch.ones(1, 4, dtype=torch.long), 2, 1,
                                    cuda_graph=True)


# --- the REPL -----------------------------------------------------------------

class _ReplTokenizer:
    eos_token_id = 2

    def __call__(self, text, add_special_tokens=True):
        ids = [3 + (ord(c) % 120) for c in text][:20]
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_repl_generates_what_greedy_generate_cached_does(
        llm_params, tmp_path, monkeypatch, capsys):
    """The REPL over a checkpoint written by the port's exporter: each
    typed line is wrapped by the prompt builder and completed as
    greedy_generate_cached completes it."""
    from vla_adapter_torch.data.prompting import QwenPromptBuilder
    from vla_adapter_torch.weights import export, load

    cfg = dataclasses.replace(TCFG, llm=TLLM)
    state = {f"language_model.model.{k}": v for k, v in
             _hf_qwen2(from_jax_params(llm_params, TLLM)).items()}
    from vla_adapter_torch.weights.safetensors_io import save_file

    save_file(state, tmp_path / "model.safetensors")
    export.write_config_json(cfg, tmp_path)
    lines = iter(["pick up the cup", "open the drawer"])

    def fake_input(prompt):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError

    tok = _ReplTokenizer()
    monkeypatch.setattr("builtins.input", fake_input)
    monkeypatch.setattr("vla_adapter_torch.data.tokenization."
                        "load_qwen_tokenizer", lambda *a, **k: tok)
    trepl.main(["--ckpt_dir", str(tmp_path), "--max_new_tokens", "5",
                "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 2
    llm = Qwen2Model(load.vla_config_from_checkpoint(tmp_path).llm,
                     Runtime(dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16), device="cpu")
    llm.load_state_dict({k: v.bfloat16() for k, v in
                         from_jax_params(llm_params, TLLM).items()})
    for text, line in zip(["pick up the cup", "open the drawer"], printed):
        b = QwenPromptBuilder()
        b.add_turn("human", text)
        ids = tok(b.get_prompt()).input_ids
        buf = torch.zeros((1, len(ids) + 5), dtype=torch.long)
        buf[0, :len(ids)] = torch.tensor(ids)
        out = tgen.greedy_generate_cached(llm, buf, len(ids), 5,
                                          eos_token_id=2)[0, len(ids):]
        assert line == tok.decode([int(t) for t in out if t != 0])


def _hf_qwen2(state):
    """The port's Qwen2Model state -> HF names (what the exporter writes)."""
    from vla_adapter_torch.weights.export import qwen2_state_to_hf

    return qwen2_state_to_hf(state, TLLM, prefix="")


def test_generate_config_parses_as_jax():
    argv = ["--ckpt_dir", "/x", "--max_new_tokens", "9", "--temperature",
            "0.5", "--prompt_family", "phi", "--image", "a.png"]
    got = dataclasses.asdict(tparse(trepl.GenerateConfig, argv))
    want = dataclasses.asdict(jparse(jrepl.GenerateConfig, argv))
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"seed", "device"}
