"""The token objective, the training stages and VLM pretraining of the
port against the JAX package's, on the CPU.

``token_prediction_loss`` and its metrics; the VLA's ``compute_logits``
(the fast tied path and the slow one); the first step of the
``objective="token"`` train step (loss, metrics, every trainable
gradient) and six steps lowering the CE (the JAX package's own check);
the eight stage predicates; two steps of "last-layer-finetune"
(parameters and Adam moments, the masked layers' exactly zero);
``pretrain`` against the JAX package's; the chat datasets and ``collate``
on the JAX package's test records. The tiny VLA of ``tests/torch_tiny.py``
in fp32 (LoRA rank 4, scale 2, head noise off), weights carried with
``from_jax_params``.

Tolerances: fp32 summation order through a few layers, 1e-4 (gradients
1e-4 of their largest; parameters after Adam steps, whose first updates
are ~lr * sign(g), 1e-4 + 1e-4 relative). Integer outputs (datasets,
argmax accuracies) are equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_tpu.core.config as jc
from tests.test_torch_vlm import JCFG as VLM_JCFG
from tests.test_torch_vlm import TCFG as VLM_TCFG
from tests.test_torch_vlm import jax_vlm_params, vlm_inputs
from tests.test_torch_train import (
    JCFG,
    JRT,
    OPT,
    TCFG,
    TRT,
    _port_model,
)
from vla_adapter_tpu.data import chat as jchat
from vla_adapter_tpu.data import collator as jcollator
from vla_adapter_tpu.data import dummy as jdummy
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JFP32
from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
from vla_adapter_tpu.models.vlm import PrismaticVLM as JVLM
from vla_adapter_tpu.train import optim as joptim
from vla_adapter_tpu.train import partition as jpart
from vla_adapter_tpu.train import pretrain as jpretrain
from vla_adapter_tpu.train import stages as jstages
from vla_adapter_tpu.train import step as jstep
from vla_adapter_torch.data import chat as tchat
from vla_adapter_torch.data import collator as tcollator
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.models.layers import FP32_RUNTIME as TFP32
from vla_adapter_torch.models.vlm import PrismaticVLM
from vla_adapter_torch.train import optim as toptim
from vla_adapter_torch.train.partition import mark_by_
from vla_adapter_torch.train import pretrain as tpretrain
from vla_adapter_torch.train import stages as tstages
from vla_adapter_torch.train import step as tstep
from vla_adapter_torch.weights.from_jax import (
    from_jax_opt_state,
    from_jax_params,
)

ATOL = RTOL = 1e-4
TOKENIZER_LEN = 151921


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


# --- the loss and its metrics ----------------------------------------------------

def test_token_prediction_loss_matches_jax():
    """At the flagship vocabulary, so that the action-token masks (ids over
    ACTION_TOKEN_BEGIN_IDX) select: current and next action accuracies and
    detokenized L1, per-sample rows."""
    rng = np.random.default_rng(0)
    b, t, v = 2, 30, TOKENIZER_LEN + 15
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    labels = np.full((b, t), -100, np.int64)
    valid = np.zeros((b, t), np.int32)
    for i, start in enumerate((4, 9)):
        ids = rng.integers(TOKENIZER_LEN - 256, TOKENIZER_LEN, size=14)
        labels[i, start:start + 14] = ids
        valid[i, :start + 15] = 1
        # make some predictions right
        logits[i, start - 1 + np.arange(0, 14, 3), ids[::3]] += 50.0
    want_loss, want = jstep.token_prediction_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid),
        TOKENIZER_LEN, 7)
    got_loss, got = tstep.token_prediction_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(valid), TOKENIZER_LEN, 7)
    _close(got_loss, want_loss, atol=1e-5, rtol=1e-5)
    for k in ("curr_action_accuracy", "next_actions_accuracy"):
        assert float(got[k]) == float(want[k]), k
        assert 0 < float(got[k]) < 1, k
    for k in ("curr_action_l1_loss", "next_actions_l1_loss"):
        _close(got[k], want[k], atol=1e-6, rtol=1e-6, msg=k)
    for k, w in want["per_sample"].items():
        _close(got["per_sample"][k], w, atol=1e-5, rtol=1e-5, msg=k)


# --- the VLA's logits ----------------------------------------------------------------

@pytest.fixture(scope="module")
def vla_params():
    from tests.test_torch_modules import jax_params

    return jax_params(seed=4)


@pytest.mark.parametrize("path", ["fast", "slow"])
def test_vla_compute_logits_matches_jax(vla_params, path):
    """Text-region logits in text coordinates: the tied head over the
    text positions (no actions), or the LLM's logits sliced (actions
    too)."""
    from tests.test_torch_modules import JCFG as MJCFG
    from tests.test_torch_modules import TCFG as MTCFG
    from tests.test_torch_modules import make_inputs

    from vla_adapter_torch.models.vla import VLAModel

    x = make_inputs(MJCFG, seed=5)
    actions = path == "slow"
    want = JaxVLA(MJCFG, JFP32).apply(
        {"params": vla_params}, compute_logits=True,
        compute_actions=actions, **{k: jnp.asarray(v) for k, v in x.items()})
    model = VLAModel(MTCFG, TFP32, device="cpu")
    model.load_state_dict(from_jax_params(vla_params, MTCFG), strict=True)
    with torch.no_grad():
        got = model.eval()(**{k: torch.from_numpy(v) for k, v in x.items()},
                           compute_logits=True, compute_actions=actions)
    assert tuple(got["logits"].shape) == (2, MJCFG.max_text_tokens,
                                          MJCFG.llm.vocab_size)
    assert ("actions" in got) == actions
    rows = np.concatenate([np.ones((2, 1), bool),
                           x["text_valid"][:, 1:].astype(bool)], axis=1)
    _close(got["logits"].numpy()[rows], np.asarray(want["logits"])[rows])
    if actions:
        _close(got["actions"], want["actions"])


# --- the train step under the token objective ------------------------------------

def token_batch(cfg, batch, seed):
    """A dummy batch with ``labels``: the action block's ids (the JAX
    package's tests/test_model_extras.py recipe)."""
    out = jdummy.make_dummy_batch(cfg, batch, np.random.default_rng(seed))
    labels = np.full_like(out["input_ids"], -100)
    q = cfg.constants.num_action_query_tokens
    for i in range(batch):
        p = out["prompt_len"][i]
        labels[i, p - 1:p + q] = out["input_ids"][i, p - 1:p + q]
    out["labels"] = labels
    return out


@pytest.fixture(scope="module")
def jax_token_state():
    from tests.test_torch_train import _jax_init

    batch = jdummy.make_dummy_batch(JCFG, 2, np.random.default_rng(0))
    tx = joptim.make_optimizer(jc.OptimizerConfig(**OPT), warmup_steps=0)
    state = _jax_init(tx, batch, 0)
    rng = np.random.default_rng(1)
    perturb = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), t)
    return state.replace(trainable=perturb(state.trainable),
                         frozen=perturb(state.frozen))


def test_token_objective_loss_and_grads_match_jax(jax_token_state):
    from vla_adapter_torch.train import partition as tpart

    s = jax_token_state
    batch = token_batch(JCFG, 2, 2)
    loss_fn = jstep.make_loss_fn(JaxVLA(JCFG, JRT), objective="token")
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        s.trainable, s.frozen, jax.tree.map(jnp.asarray, batch),
        jax.random.key(0))
    model = _port_model(jpart.merge_trees(s.trainable, s.frozen))
    names = tpart.mark_trainable_(model, lora_enabled=True)
    params = dict(model.named_parameters())
    loss_t, m_t = tstep.make_loss_fn(model, "token")(
        tstep.to_device(batch, "cpu"), None)
    grads = torch.autograd.grad(loss_t, [params[n] for n in names],
                                allow_unused=True)
    _close(loss_t, loss_j)
    for k in ("curr_action_accuracy", "next_actions_accuracy",
              "curr_action_l1_loss", "next_actions_l1_loss"):
        _close(m_t[k], m_j[k], msg=k)
    want = from_jax_params(g_j, TCFG)
    assert set(want) == set(names)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for n, g in zip(names, grads):
        if g is None:  # the head: not in the token objective's graph
            assert not want[n].any(), n
            continue
        _close(g, want[n], atol=ATOL * scale, msg=n)


def test_token_objective_six_steps_lower_the_ce():
    """The JAX package's tests/test_model_extras.py check on the port's
    train step: LoRA rank 2, six steps on one batch."""
    from vla_adapter_torch.models.layers import Runtime, init_random_
    from vla_adapter_torch.models.vla import VLAModel

    rt = Runtime(dtype=torch.float32, param_dtype=torch.float32,
                 lora_rank=2, lora_scale=2.0)
    model = init_random_(VLAModel(TCFG, rt, device="cpu"),
                         torch.Generator().manual_seed(0))
    tcfg = tc.TrainConfig(model=TCFG, objective="token",
                          optim=tc.OptimizerConfig(**{**OPT, "max_steps": 50}))
    tx = toptim.make_optimizer(tcfg.optim, warmup_steps=0)
    state = tstep.init_train_state(model, tx, lora_enabled=True)
    step = tstep.make_train_step(model, tx, tcfg)
    batch = tstep.to_device(token_batch(JCFG, 2, 0), "cpu")
    losses = []
    for i in range(6):
        m = step(state, batch, i)
        losses.append(float(m["loss"]))
        assert "curr_action_accuracy" in m
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_unknown_objective_raises():
    with pytest.raises(ValueError, match="objective"):
        tstep.make_loss_fn(None, "bogus")


# --- stages -------------------------------------------------------------------------

@pytest.mark.parametrize("stage", tstages.STAGES)
def test_stage_predicates_match_jax(stage, vla_params):
    """Each stage's predicate over every parameter path of a LoRA VLA and
    of a PrismaticVLM, against the JAX package's over the same paths."""
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.vla import VLAModel

    paths = set()
    for model in (VLAModel(TCFG, Runtime(lora_rank=2), device="meta"),
                  PrismaticVLM(VLM_TCFG, TFP32, device="meta")):
        paths |= {tuple(n.split(".")) for n, _ in model.named_parameters()}
    got, want = tstages.stage_predicate(stage), jstages.stage_predicate(stage)
    for p in sorted(paths):
        assert got(p) == want(p), p
    assert any(got(p) for p in paths)
    with pytest.raises(ValueError):
        tstages.stage_predicate("bogus")


@pytest.fixture(scope="module")
def vlm_params():
    return jax_vlm_params(VLM_JCFG, seed=11)


def test_last_layer_finetune_two_steps_match_jax(vlm_params):
    """Two AdamW steps (weight decay on) of "last-layer-finetune": every
    trainable tensor and both moments against the JAX package's; layers
    before the last get exactly zero updates and moments; the frozen
    modules and the final norm do not move."""
    stage = "last-layer-finetune"
    optim = jc.OptimizerConfig(learning_rate=1e-3, weight_decay=0.1,
                               max_steps=10, num_steps_before_decay=100)
    batches = [vlm_inputs(VLM_JCFG, seed=12 + i) for i in range(2)]

    trainable, frozen = jstages.split_by_stage(vlm_params, stage)
    tx = joptim.mask_updates(joptim.make_optimizer(optim, warmup_steps=0),
                             jstages.stage_update_mask(trainable, stage))
    opt_state = tx.init(trainable)
    step_j = jax.jit(jpretrain.make_pretrain_step(JVLM(VLM_JCFG, JFP32), tx))
    for b in batches:
        trainable, opt_state, m_j = step_j(
            trainable, frozen, opt_state, jax.tree.map(jnp.asarray, b))

    model = PrismaticVLM(VLM_TCFG, TFP32, device="cpu")
    model.load_state_dict(from_jax_params(vlm_params, VLM_TCFG), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    names = mark_by_(model, tstages.stage_predicate(stage))
    params = dict(model.named_parameters())
    train_t = {n: params[n] for n in names}
    tx_t = toptim.mask_updates(
        toptim.make_optimizer(tc.OptimizerConfig(
            learning_rate=1e-3, weight_decay=0.1, max_steps=10,
            num_steps_before_decay=100), warmup_steps=0),
        tstages.stage_update_mask(train_t, stage))
    state_t = tx_t.init(train_t)
    step_t = tpretrain.make_pretrain_step(model, tx_t, train_t)
    for b in batches:
        state_t, m_t = step_t(state_t, tstep.to_device(b, "cpu"))
    _close(m_t["loss"], m_j["loss"])

    want = from_jax_params(trainable, VLM_TCFG)
    assert set(want) == set(names)
    for n in names:
        _close(train_t[n], want[n], atol=ATOL, rtol=ATOL, msg=n)
    moments = from_jax_opt_state(opt_state, VLM_TCFG)
    last = VLM_TCFG.llm.num_layers - 1
    for part in ("mu", "nu"):
        scale = max(float(v.abs().max()) for v in moments[part].values())
        for n in names:
            _close(state_t[part][n], moments[part][n], atol=ATOL * scale,
                   msg=f"{part} {n}")
            if n.startswith("language_model.layers.") and \
                    int(n.split(".")[2]) != last:
                assert not state_t[part][n].any(), n
    after = model.state_dict()
    for n, v in before.items():
        moved = not torch.equal(after[n], v)
        should = n.startswith((f"language_model.layers.{last}.",
                               "language_model.embed."))
        assert moved == should, n


def test_pretrain_matches_jax(vlm_params):
    """Three steps of ``pretrain`` ("finetune": projector and LLM) from the
    same init: the last loss and every parameter."""
    cfg_kw = dict(stage="finetune", batch_size=2,
                  optim=dict(learning_rate=1e-3, max_steps=3,
                             num_steps_before_decay=100))
    jcfg = jpretrain.PretrainConfig(
        model=VLM_JCFG, **{**cfg_kw, "optim": jc.OptimizerConfig(
            **cfg_kw["optim"])})
    tcfg = tpretrain.PretrainConfig(
        model=VLM_TCFG, **{**cfg_kw, "optim": tc.OptimizerConfig(
            **cfg_kw["optim"])}, device="cpu")
    batches = [{k: v for k, v in vlm_inputs(VLM_JCFG, seed=20 + i).items()}
               for i in range(3)]
    params_j, m_j = jpretrain.pretrain(jcfg, iter(batches), 3, rt=JFP32,
                                       init_params=vlm_params)
    params_t, m_t = tpretrain.pretrain(
        tcfg, iter(batches), 3, rt=TFP32,
        init_params=from_jax_params(vlm_params, VLM_TCFG))
    _close(m_t["loss"], m_j["loss"])
    want = from_jax_params(jax.device_get(params_j), VLM_TCFG)
    assert set(params_t) == set(want)
    for n, v in want.items():
        _close(params_t[n], v, msg=n)


def test_pretrain_graft_takes_whole_modules():
    model = PrismaticVLM(VLM_TCFG, TFP32, device="cpu")
    state = {k: torch.full_like(v, 0.5) for k, v in model.state_dict().items()
             if k.startswith("projector.")}
    state["action_head.fc_in.weight"] = torch.zeros(3)  # ignored
    assert tpretrain.graft(model, state) == ["projector"]
    assert all((v == 0.5).all() for k, v in model.state_dict().items()
               if k.startswith("projector."))
    del state["projector.fc1.bias"]
    with pytest.raises(KeyError, match="missing"):
        tpretrain.graft(model, state)


# --- chat datasets and collation --------------------------------------------------

def _records(n=6):
    """The JAX package's tests/test_pretrain.py records: every other one
    without an image here, so that both kinds are packed."""
    return [{**({"image": f"img_{i}.png"} if i % 2 == 0 else {}),
             "conversations": [
                 {"from": "human", "value": f"<image>\ndescribe scene {i}"},
                 {"from": "gpt", "value": f"a robot arm near object {i}"},
                 {"from": "human", "value": "and then?"},
                 {"from": "gpt", "value": ""}]}
            for i in range(n)]


@pytest.mark.parametrize("kind", ["align", "finetune"])
def test_chat_datasets_and_collate_match_jax(tmp_path, monkeypatch, kind):
    recs = _records()
    path = tmp_path / "chat.json"
    path.write_text(json.dumps(recs))

    def pixels(self, record):
        if "image" not in record:
            return None
        return np.full((1, 28, 28, 3), float(len(record["image"])),
                       np.float32)

    for mod in (jchat, tchat):
        for cls in (mod.AlignDataset, mod.FinetuneDataset):
            monkeypatch.setattr(cls, "_pixels", pixels)
    jtok, ttok = JaxMockTokenizer(), MockTokenizer()
    name = "AlignDataset" if kind == "align" else "FinetuneDataset"
    kw = dict(max_text_tokens=48, eos_token_id=5)
    if kind == "finetune":
        kw["prompt_family"] = "qwen"
    jds = getattr(jchat, name)(str(path), lambda t: jtok(t).input_ids, None,
                               **kw)
    tds = getattr(tchat, name)(str(path), lambda t: ttok(t).input_ids, None,
                               **kw)
    assert len(tds) == len(jds) == 6
    for i in range(6):
        a, b = tds[i], jds[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    for idx, accum in (([0, 2, 4, 0], None), ([1, 3, 5, 1], 2)):
        a = tcollator.collate([tds[i] for i in idx], accum)
        b = jcollator.collate([jds[i] for i in idx], accum)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="present in"):
        tcollator.collate([tds[0], tds[1]])


@pytest.mark.parametrize("family", ["qwen", "pure", "llama2-chat", "vicuna",
                                    "mistral-instruct", "phi"])
def test_prompt_builders_match_jax(family):
    from vla_adapter_tpu.data.prompting import PROMPT_BUILDERS as JPB
    from vla_adapter_torch.data.prompting import PROMPT_BUILDERS as TPB

    a, b = TPB[family]("openvla"), JPB[family]("openvla")
    for role, msg in (("human", "<image>\nwhat is this? "), ("gpt", "a cup"),
                      ("human", "and now"), ("gpt", "")):
        assert a.add_turn(role, msg) == b.add_turn(role, msg)
        assert a.get_prompt() == b.get_prompt()
    with pytest.raises(ValueError):
        a.add_turn("gpt", "out of turn")


# --- chip_smoke.py's derived launch counts of phases 12-15 ---------------------

def test_chip_smoke_derives_the_causal_path_launches():
    """Generation: the prefill's B1 per layer and, under w8a8 "fused", B4 at
    q and o (k and v, 896 -> 128, stay weight-only) and B2 per layer in the
    prefill and in each of the 64 steps (a bf16 step launches no
    hand-written kernel). Phi-2 under w8a8: B1 per layer and B4 at its six
    Denses per layer and the untied lm_head, per uncached step; at one row
    fc1, fc2 and the lm_head (splits over K too wide for the narrow
    branch's CTAs to be resident) take the Hopper branch with its
    quantization pre-pass, and at the 128-row prompt every Dense but the
    lm_head (on the last row) does. Pretraining:
    B1 on the 73 attention layers, B1-bwd's three kernels on the 24 LLM
    layers in both stages, none on the frozen towers."""
    import chip_smoke

    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.phi import PhiModel
    from vla_adapter_torch.models.qwen2 import Qwen2Model
    from vla_adapter_torch.models.registry import get_llm_backbone
    from vla_adapter_torch.ops import fused_mlp, w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        KERNEL_NAME,
    )

    cfg = tc.VLAConfig()
    bf16 = Runtime()
    w8a8 = dataclasses.replace(bf16, weights_int8=True, act_int8=True,
                               w8a8_impl="fused")
    b4, b2 = w8a8_matmul.KERNEL_NAME, fused_mlp.GATED_KERNEL_NAME
    assert chip_smoke.expected_generate_launches(
        Qwen2Model(cfg.llm, bf16, device="meta"), 64) == {KERNEL_NAME: 24}
    assert chip_smoke.expected_generate_launches(
        Qwen2Model(cfg.llm, w8a8, device="meta"), 64) == {
            KERNEL_NAME: 24, b4: 48 * 65, b2: 24 * 65}
    phi = get_llm_backbone("phi-2-3b")
    assert chip_smoke.llm_pass_launches(
        PhiModel(phi, w8a8, device="meta"), attention=True) == {
            KERNEL_NAME: 32, b4: 6 * 32 + 1,
            w8a8_matmul.QUANT_KERNEL_NAME: 2 * 32 + 1}
    assert chip_smoke.llm_pass_launches(
        PhiModel(phi, w8a8, device="meta"), attention=True, rows=128) == {
            KERNEL_NAME: 32, b4: 6 * 32 + 1,
            w8a8_matmul.QUANT_KERNEL_NAME: 6 * 32 + 1}
    assert chip_smoke.llm_pass_launches(
        PhiModel(phi, bf16, device="meta"), attention=True) == {
            KERNEL_NAME: 32}
    vlm = PrismaticVLM(dataclasses.replace(cfg, use_proprio=False),
                       device="meta")
    state = vlm.state_dict()
    for stage in ("align", "last-layer-finetune"):
        trainable, _ = tstages.split_by_stage(state, stage)
        assert chip_smoke.expected_pretrain_launches(vlm, trainable) == {
            KERNEL_NAME: 73, BWD_KERNEL_NAME: 3 * 24}, stage
    trainable, _ = tstages.split_by_stage(state, "full-finetune")
    assert chip_smoke.expected_pretrain_launches(vlm, trainable) == {
        KERNEL_NAME: 73, BWD_KERNEL_NAME: 3 * 73}
    assert [s["m"] for s in chip_smoke.decode_shapes(cfg)] == [1, 1, 2, 2,
                                                              4, 4]
    assert {(s["m"], s["k"], s["n"]) for s in chip_smoke.phi_b4_shapes(
        phi, 136)} == {(136, 2560, 2560), (136, 2560, 10240),
                       (136, 10240, 2560), (1, 2560, 51200)}
