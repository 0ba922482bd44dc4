"""Five small public names of the JAX package and their counterparts in the
port, held against the JAX package's results on the CPU:
``MockTokenizer.decode``, ``VLABatchTransform.inference_ids``,
``TrainConfig.replace``, ``data.image_processing.default_image_processor``
and ``utils.overwatch.local_zero_first`` (one process, and a 2-rank gloo
group started by ``tests/torch_dist_worker.py``, where rank 0 must leave
the body before rank 1 enters it).
"""

import dataclasses
import json

import numpy as np
import pytest

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from tests import torch_dist_worker as worker
from tests.torch_tiny import tiny_cfg
from vla_adapter_tpu.data import image_processing as jimg
from vla_adapter_tpu.data import tokenization as jtok
from vla_adapter_tpu.data import transform as jtransform
from vla_adapter_tpu.data.action_tokenizer import ActionTokenizer as JaxActTok
from vla_adapter_torch.data import image_processing as timg
from vla_adapter_torch.data import tokenization as ttok
from vla_adapter_torch.data import transform as ttransform
from vla_adapter_torch.data.action_tokenizer import ActionTokenizer
from vla_adapter_torch.utils import overwatch


@pytest.mark.parametrize("ids", [[], [0], [3, 151920, 7, 7], np.arange(5)])
def test_mock_tokenizer_decode_matches_jax(ids):
    got = ttok.MockTokenizer().decode(ids)
    assert got == jtok.MockTokenizer().decode(ids)
    words = "put the bowl on the plate"
    enc = ttok.MockTokenizer()(words).input_ids
    assert ttok.MockTokenizer().decode(enc) == jtok.MockTokenizer().decode(
        enc) == " ".join(f"<{i}>" for i in enc)


@pytest.mark.parametrize("instruction", ["open the drawer",
                                         "PUT both the alphabet soup and "
                                         "the tomato sauce in the basket"])
def test_batch_transform_inference_ids_matches_jax(instruction):
    """The method's (input_ids, prompt_len, valid), all three arrays, as
    the JAX package's method gives them, and as the port's module
    function does."""
    jcfg, tcfg = tiny_cfg(jc, jk), tiny_cfg(tc, tk)
    jt, tt = jtok.MockTokenizer(), ttok.MockTokenizer()
    jx = jtransform.VLABatchTransform(
        jcfg, tokenize=lambda s: jt(s).input_ids,
        action_tokenizer=JaxActTok(len(jt)))
    tx = ttransform.VLABatchTransform(
        tcfg, tokenize=lambda s: tt(s).input_ids,
        action_tokenizer=ActionTokenizer(len(tt)))
    got, want = tx.inference_ids(instruction), jx.inference_ids(instruction)
    module = ttransform.inference_ids(tcfg, tx.tokenize, instruction)
    assert len(got) == len(want) == 3
    for g, w, m in zip(got, want, module):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, m)


def _json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)


@pytest.mark.parametrize("field", ["scalar", "optional", "tuple", "nested",
                                   "model", "several"])
def test_train_config_replace_matches_jax(field):
    """``replace`` on each kind of field (a number, an Optional, a tuple,
    a nested config, the model, several at once) gives the JAX package's
    config; the original is left as it was."""
    kw = {
        "scalar": lambda C, K: dict(batch_size=3),
        "optional": lambda C, K: dict(accum_dtype="bfloat16",
                                      run_id="r"),
        "tuple": lambda C, K: dict(remat_components=("llm",)),
        "nested": lambda C, K: dict(optim=C.OptimizerConfig(
            learning_rate=2e-5, max_steps=7),
            lora=C.LoRAConfig(enabled=False)),
        "model": lambda C, K: dict(model=tiny_cfg(C, K)),
        "several": lambda C, K: dict(base_int8=True, grad_accumulation_steps=2,
                                     save_freq=5, frozen_bf16=False),
    }[field]
    tbase, jbase = tc.TrainConfig(), jc.TrainConfig()
    got = tbase.replace(**kw(tc, tk))
    want = jbase.replace(**kw(jc, jk))
    assert isinstance(got, tc.TrainConfig)
    assert _json(got) == _json(want)
    assert _json(tbase) == _json(tc.TrainConfig())
    with pytest.raises(TypeError):
        tbase.replace(no_such_field=1)


def test_default_image_processor_matches_jax():
    """The default processor (DINOv2 and SigLIP at 224 px) on the same
    images, a square one and two that are resampled, as the JAX package's
    pixels."""
    rng = np.random.default_rng(3)
    got_proc, want_proc = (timg.default_image_processor(),
                           jimg.default_image_processor())
    assert len(got_proc.towers) == 2
    for shape in [(224, 224, 3), (256, 256, 3), (180, 300, 3)]:
        image = rng.integers(0, 256, size=shape, dtype=np.uint8)
        got, want = got_proc(image), want_proc(image)
        assert got.shape == want.shape == (224, 224, 6)
        np.testing.assert_array_equal(got, want)


def test_local_zero_first_in_one_process():
    """Without a process group the body runs at once, exactly once."""
    seen = []
    with overwatch.local_zero_first():
        seen.append(overwatch.process_index())
    assert seen == [0]


def test_local_zero_first_on_two_gloo_ranks(tmp_path):
    """Under a 2-rank gloo group rank 0 enters and leaves the body before
    rank 1 enters it (rank 0 stays inside for ZERO_FIRST_HOLD_S); both
    ranks run the body once."""
    recs = worker.wait(*worker.start(tmp_path, "zero_first", 2))
    assert [r["rank"] for r in recs] == [0, 1]
    order = (tmp_path / "order.log").read_text().split("\n")
    assert order == ["enter 0", "exit 0", "enter 1", "exit 1", ""], order
