"""The port's finetune entry point on its RLDS pipeline, against the JAX
package's, on the CPU at the tiny size.

Both packages' ``build_data_iter`` read the same seeded synthetic LIBERO
trajectories (each package's TFDS reader monkeypatched to yield them) and
a mock tokenizer; with augmentation and the shuffle buffer off their
batches are equal, and the 3-step LoRA finetunes from the same initial
weights give losses within ``tests/test_torch_train.py``'s 1e-4, with the
same ``dataset_statistics.json`` in the checkpoints.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from tests.test_torch_rlds import TRAJS, libero_trajs, tf_source  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    JRT,
    TRT,
    _close,
    _finetune_cfgs,
    _initial_params,
)
from vla_adapter_torch.data.rlds import dataset as tds  # noqa: E402
from vla_adapter_torch.data.tokenization import (  # noqa: E402
    MockTokenizer as TMock,
)
from vla_adapter_torch.train import checkpoints as tckpt  # noqa: E402
from vla_adapter_torch.train import finetune as tfinetune  # noqa: E402
from vla_adapter_torch.train import loop as tloop  # noqa: E402
from vla_adapter_tpu.data.rlds import dataset as jds  # noqa: E402
from vla_adapter_tpu.data.tokenization import (  # noqa: E402
    MockTokenizer as JMock,
)
from vla_adapter_tpu.train import checkpoints as jckpt  # noqa: E402
from vla_adapter_tpu.train import finetune as jfinetune  # noqa: E402
from vla_adapter_tpu.train import loop as jloop  # noqa: E402

VOCAB = 512  # the tiny model's: action ids must index it
REAL_READER = tds.load_tfds_trajectories


def _sources(name):
    """Other trajectories per dataset name (the mixture's members)."""
    names = ("libero_spatial_no_noops", "libero_object_no_noops",
             "libero_goal_no_noops", "libero_10_no_noops")
    return TRAJS if name == names[0] else libero_trajs(
        seed=names.index(name) + 10, num=3)


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """Both packages' TFDS readers and tokenizer loaders monkeypatched;
    statistics caches under a temporary home. Yields the port reader's
    calls."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        calls = []
        _patch_readers(monkeypatch, tmp_path_factory.mktemp("home"), calls)
        yield calls


def _patch_readers(monkeypatch, home, calls):
    import vla_adapter_torch.data.tokenization as ttok
    import vla_adapter_tpu.data.tokenization as jtok

    monkeypatch.setenv("HOME", str(home))

    def port_reader(name, data_dir, train, shuffle, num_parallel_reads=-1,
                    split=None, shard=(0, 1)):
        calls.append((name, split, shard))
        return tds._shard(_sources(name), shard)

    def jax_reader(name, data_dir, train, shuffle, num_parallel_reads=None,
                   split=None):
        return tf_source(_sources(name))

    monkeypatch.setattr(tds, "load_tfds_trajectories", port_reader)
    monkeypatch.setattr(jds, "load_tfds_trajectories", jax_reader)
    monkeypatch.setattr(ttok, "load_qwen_tokenizer",
                        lambda _dir: TMock(length=VOCAB))
    monkeypatch.setattr(jtok, "load_qwen_tokenizer",
                        lambda _dir: JMock(length=VOCAB))


def _cli_cfgs(root, mixture="libero_spatial_no_noops", **data):
    jtrain, ttrain = _finetune_cfgs(root)
    kw = dict(mixture=mixture, root_dir=str(root / "rlds"), image_aug=False,
              shuffle_buffer_size=1)
    kw.update(data)
    return (jfinetune.FinetuneCLIConfig(train=jtrain,
                                        data=jfinetune.DataConfig(**kw)),
            tfinetune.FinetuneCLIConfig(
                train=ttrain, device="cpu",
                data=tfinetune.DataConfig(num_workers=0, **kw)))


def _jax_losses(jcfg, data_iter, stats):
    losses = []
    orig = jloop.Metrics.commit

    def commit(self, **m):
        if "loss" in m:
            losses.append(float(m["loss"]))
        return orig(self, **m)

    jloop.Metrics.commit = commit
    try:
        jloop.finetune(jcfg, data_iter=data_iter, dataset_statistics=stats,
                       rt=JRT)
    finally:
        jloop.Metrics.commit = orig
    return losses


@pytest.fixture(scope="module")
def both_finetuned(readers, tmp_path_factory):
    jcli, tcli = _cli_cfgs(tmp_path_factory.mktemp("ft"))
    jit, jstats = jfinetune.build_data_iter(jcli)
    tit, tstats = tfinetune.build_data_iter(tcli)
    # the batches both packages train on, held aside and compared
    jb = [next(jit) for _ in range(3)]
    tb = [next(tit) for _ in range(3)]
    losses_j = _jax_losses(jcli.train, iter(jb), jstats)
    rt = dataclasses.replace(TRT, remat=True, remat_components=("vit", "llm"))
    state = tloop.finetune(tcli.train, data_iter=iter(tb),
                           dataset_statistics=tstats, rt=rt, device="cpu",
                           params=_initial_params(jcli.train))
    return dict(jcli=jcli, tcli=tcli, jb=jb, tb=tb, jstats=jstats,
                tstats=tstats, losses_j=losses_j, state=state)


def test_build_data_iter_batches_match_jax(both_finetuned, readers):
    from tests.test_torch_rlds import assert_batches

    r = both_finetuned
    assert r["tstats"] == r["jstats"]
    for g, w in zip(r["tb"], r["jb"]):
        assert_batches(g, w)
        assert g["input_ids"].shape == (2, 96)
    # the statistics read split "all"; one process reads everything
    assert ("libero_spatial_no_noops", "all", (0, 1)) in readers
    assert {shard for _, _, shard in readers} == {(0, 1)}


def test_finetune_on_rlds_tracks_jax(both_finetuned):
    r = both_finetuned
    losses_t = [h["loss"] for h in r["state"].history]
    assert len(losses_t) == len(r["losses_j"]) == 3
    assert np.isfinite(losses_t).all()
    _close(np.asarray(losses_t), np.asarray(r["losses_j"]))


def test_checkpoint_statistics_equal_jax(both_finetuned):
    r = both_finetuned
    tdir = tckpt.find_resume_checkpoint(
        f"{r['tcli'].train.run_root_dir}/{r['tcli'].train.run_id}")
    jdir = jckpt.find_resume_checkpoint(
        f"{r['jcli'].train.run_root_dir}/{r['jcli'].train.run_id}")
    got = json.loads((tdir / "dataset_statistics.json").read_text())
    want = json.loads((jdir / "dataset_statistics.json").read_text())
    assert got == want == json.loads(json.dumps(r["tstats"]))
    assert set(got) == {"libero_spatial_no_noops"}


def test_mixture_finetune_reports_each_dataset(readers, tmp_path):
    """The CLI on a four-dataset mixture, augmentation and the shuffle
    buffer on: finite losses, and each dataset's own loss in the metrics
    record."""
    _, tcli = _cli_cfgs(tmp_path, mixture="libero_4_task_suites_no_noops",
                        image_aug=True, shuffle_buffer_size=64)
    train = dataclasses.replace(tcli.train, batch_size=8, log_freq=1)
    tcli = dataclasses.replace(tcli, train=train)
    data_iter, stats = tfinetune.build_data_iter(tcli)
    state = tloop.finetune(tcli.train, data_iter=data_iter,
                           dataset_statistics=stats, rt=TRT, device="cpu")
    assert np.isfinite([h["loss"] for h in state.history]).all()
    names = set(stats)
    assert len(names) == 4
    lines = (tmp_path / "port" / train.run_id / "metrics.jsonl").read_text()
    keys = set().union(*(json.loads(line) for line in lines.splitlines()))
    assert {f"{n}/loss" for n in names} <= keys


def test_cli_without_tensorflow_datasets(readers, monkeypatch, tmp_path):
    """``--data.use_dummy false`` trains on RLDS or fails: without
    tensorflow_datasets the reader's ImportError names the package."""
    monkeypatch.setattr(tds, "load_tfds_trajectories", REAL_READER)
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", None)
    with pytest.raises(ImportError, match="tensorflow_datasets"):
        tfinetune.main(["--device", "cpu", "--data.use_dummy", "false",
                        "--data.num_workers", "0",
                        "--data.root_dir", str(tmp_path),
                        "--train.optim.max_steps", "1"])
