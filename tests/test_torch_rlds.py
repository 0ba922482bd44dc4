"""The port's RLDS data engine (``vla_adapter_torch/data/rlds``, numpy)
against the JAX package's tf.data one, on seeded synthetic LIBERO-shaped
trajectories (``chip_smoke.synthetic_libero_trajectories``).

Tolerances: statistics equal; normalized actions and proprio within
1e-6; chunking, pad masks, filters and thread allocation exact; decoded
and resized frames within one uint8 level (the share of exact pixels is
recorded); batches of ``RLDSDataset(train=False, image_aug=False)``: ids,
labels, validity, prompt lengths and dataset names equal, actions and
proprio within 1e-6, pixels within what one uint8 level becomes after the
image processor. TF's random draws cannot be reproduced, so the
interleaved mixture is held by its set of frames and its proportions.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import vla_adapter_torch.core.config as tc  # noqa: E402
import vla_adapter_torch.core.constants as tk  # noqa: E402
import vla_adapter_tpu.core.config as jc  # noqa: E402
import vla_adapter_tpu.core.constants as jk  # noqa: E402
from chip_smoke import synthetic_libero_trajectories  # noqa: E402
from tests.torch_tiny import tiny_cfg  # noqa: E402
from vla_adapter_torch.data import rlds_dataset as trd  # noqa: E402
from vla_adapter_torch.data.rlds import dataset as tds  # noqa: E402
from vla_adapter_torch.data.rlds.oxe.materialize import (  # noqa: E402
    make_oxe_dataset_kwargs as t_oxe_kwargs,
)
from vla_adapter_tpu.data import rlds_dataset as jrd  # noqa: E402
from vla_adapter_tpu.data.rlds import dataset as jds  # noqa: E402
from vla_adapter_tpu.data.rlds.oxe.materialize import (  # noqa: E402
    make_oxe_dataset_kwargs as j_oxe_kwargs,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JCFG, TCFG = tiny_cfg(jc, jk), tiny_cfg(tc, tk)
VOCAB = JCFG.llm.vocab_size  # action ids must index the tiny vocabulary
FUTURE = TCFG.constants.num_actions_chunk - 1


def libero_trajs(seed=0, num=4, lengths=(12, 20), image_size=64):
    return synthetic_libero_trajectories(seed, num, lengths=lengths,
                                         image_size=image_size, pool=8)


TRAJS = libero_trajs()


def tf_source(trajs):
    """The same raw trajectories as a tf.data dataset for the JAX side."""
    spec = {
        "observation": {
            "image": tf.TensorSpec([None], tf.string),
            "wrist_image": tf.TensorSpec([None], tf.string),
            "state": tf.TensorSpec([None, 8], tf.float32),
        },
        "action": tf.TensorSpec([None, 7], tf.float32),
        "language_instruction": tf.TensorSpec([None], tf.string),
    }
    return tf.data.Dataset.from_generator(lambda: iter(trajs),
                                          output_signature=spec)


def kwargs_pair(trajs=TRAJS, name="libero_spatial_no_noops", **over):
    """(JAX kwargs, port kwargs) of one LIBERO dataset over ``trajs``, no
    statistics cache (data_dir None)."""
    j = j_oxe_kwargs(name, "/unused", load_camera_views=("primary", "wrist"))
    t = t_oxe_kwargs(name, "/unused", load_camera_views=("primary", "wrist"))
    j.update(data_dir=None, traj_dataset=tf_source(trajs), **over)
    t.update(data_dir=None, traj_source=trajs, **over)
    return j, t


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    """Statistics caches go under tmp_path, never the real home."""
    monkeypatch.setenv("HOME", str(tmp_path))


def assert_trees(got, want, atol=0.0, path=""):
    """Nested dicts equal: strings and integers exactly, floats to
    ``atol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees(got[k], want[k], atol, f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind in "fc":
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)
    else:
        assert g.tolist() == w.tolist(), path


def test_restructure_statistics_and_normalization():
    jkw, tkw = kwargs_pair()
    jds_, jstats = jds.make_dataset_from_rlds(train=True, **jkw)
    tds_, tstats = tds.make_dataset_from_rlds(train=True, **tkw)
    assert tstats == jstats
    assert tstats["action"]["mask"] == [True] * 6 + [False]
    want = list(jds_.as_numpy_iterator())
    got = list(tds_)
    assert len(got) == len(want) == len(TRAJS)
    for g, w in zip(got, want):
        assert_trees(g, w, atol=1e-6)
        assert np.abs(g["action"][:, :6]).max() <= 1.0
    # a second pass over the stream sees the same data (sources untouched)
    assert_trees(list(tds_)[0], got[0])


@pytest.mark.parametrize("norm", ["normal", "bounds", "bounds_q99"])
def test_normalization_types_and_degenerate_dims(norm):
    """Each scheme; a constant action dimension (min == max) goes to 0
    whatever the mask says."""
    trajs = libero_trajs(seed=3, num=2, lengths=(10, 12))
    for t in trajs:
        t["action"][:, 2] = 0.25
    jkw, tkw = kwargs_pair(
        trajs, action_proprio_normalization_type=jk.NormalizationType(norm))
    tkw["action_proprio_normalization_type"] = tk.NormalizationType(norm)
    want = list(jds.make_dataset_from_rlds(train=True, **jkw)[0]
                .as_numpy_iterator())
    got = list(tds.make_dataset_from_rlds(train=True, **tkw)[0])
    for g, w in zip(got, want):
        assert_trees(g, w, atol=1e-6)
        if norm != "normal":
            assert (g["action"][:, 2] == 0).all()


def _traj_pipelines(trajs=TRAJS, norm="bounds_q99", **traj_kwargs):
    jkw, tkw = kwargs_pair(trajs)
    jkw["action_proprio_normalization_type"] = jk.NormalizationType(norm)
    tkw["action_proprio_normalization_type"] = tk.NormalizationType(norm)
    jd, _ = jds.make_dataset_from_rlds(train=True, **jkw)
    td, _ = tds.make_dataset_from_rlds(train=True, **tkw)
    want = jds.apply_trajectory_transforms(jd, train=True, **traj_kwargs)
    got = tds.apply_trajectory_transforms(td, train=True, **traj_kwargs)
    return list(got), list(want.as_numpy_iterator())


@pytest.mark.parametrize("window,future", [(1, FUTURE), (3, FUTURE), (2, 0)])
def test_chunk_act_obs_and_pad_masks_exact(window, future):
    got, want = _traj_pipelines(window_size=window,
                                future_action_window_size=future)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_trees(g, w)
        assert g["action"].shape[1:] == (window + future, 7)
        assert g["observation"]["pad_mask"].shape[1] == window


def test_goal_relabeling_writes_only_the_task():
    """Uniform goal relabeling draws goals from the future; everything
    outside ``task`` equals the JAX pipeline's (whose draws differ)."""
    got, want = _traj_pipelines(goal_relabeling_strategy="uniform",
                                window_size=1,
                                future_action_window_size=FUTURE)
    for g, w in zip(got, want):
        for key in ("observation", "action", "dataset_name"):
            assert_trees(g[key], w[key])
        assert set(g["task"]) == set(w["task"])
        assert (g["task"]["timestep"] > g["observation"]["timestep"][:, 0]
                ).all() or len(g["action"]) <= 1


def test_filters_skip_unlabeled_max_action_max_proprio():
    """Each filter drops its trajectory: one without an instruction, one
    with an action outlier, one with a state outlier (z-scores under the
    "normal" scheme, which does not clip)."""
    trajs = libero_trajs(seed=5, num=5, lengths=(10, 14))
    trajs[1]["language_instruction"] = np.full(
        len(trajs[1]["action"]), b"", object)
    trajs[3]["action"][0, 0] = 50.0
    trajs[2]["observation"]["state"][0, 0] = 80.0
    for kw, dropped in ((dict(skip_unlabeled=True), 1),
                        (dict(max_action=5.0), 3),
                        (dict(max_proprio=5.0), 2)):
        got, want = _traj_pipelines(trajs, norm="normal", **kw)
        kept = [i for i in range(len(trajs)) if i != dropped]
        assert [len(g["action"]) for g in got] == \
            [len(trajs[i]["action"]) for i in kept], kw
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees(g, w, atol=1e-6)


@pytest.mark.parametrize("n,weights", [
    (None, [0.5, 0.5]), (10, [0.5, 0.3, 0.2]), (3, [0.9, 0.05, 0.05]),
    (7, [0.01, 0.01, 0.98]), (12, [1, 2, 3, 4])])
def test_allocate_threads_exact(n, weights):
    got = tds.allocate_threads(n, np.asarray(weights, float))
    want = jds.allocate_threads(n, np.asarray(weights, float))
    assert got.tolist() == want.tolist()


def test_decoded_frames_within_one_level(record_property):
    """Decode (PIL vs tf.io.decode_image) and lanczos3 resize (numpy vs
    tf.image.resize), frame by frame."""
    exact = total = 0
    worst = 0
    for size in ((28, 28), (40, 24)):
        kw = dict(window_size=1, future_action_window_size=FUTURE)
        jkw, tkw = kwargs_pair()
        jd = jds.flatten_trajectories(jds.apply_trajectory_transforms(
            jds.make_dataset_from_rlds(train=False, **jkw)[0], train=False,
            **kw))
        td = tds.flatten_trajectories(tds.apply_trajectory_transforms(
            tds.make_dataset_from_rlds(train=False, **tkw)[0], train=False,
            **kw))
        want = list(jds.apply_frame_transforms(jd, train=False,
                                               resize_size=size)
                    .as_numpy_iterator())
        got = list(tds.apply_frame_transforms(td, train=False,
                                              resize_size=size))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for cam in ("image_primary", "image_wrist"):
                a = g["observation"][cam].astype(int)
                b = w["observation"][cam].astype(int)
                assert a.shape == b.shape == (1, *size, 3)
                worst = max(worst, int(np.abs(a - b).max()))
                exact += int((a == b).sum())
                total += a.size
    record_property("exact_pixel_share", exact / total)
    assert worst <= 1


def test_jpeg_decode_against_tf(record_property):
    """PIL and tf.io.decode_image on the same JPEG bytes (both libjpeg):
    the largest difference is recorded, and must stay within one level."""
    from vla_adapter_torch.data.rlds.obs_transforms import decode_image

    frames = TRAJS[0]["observation"]["image"][:8]
    diffs = [np.abs(decode_image(f).astype(int)
                    - tf.io.decode_image(f, expand_animations=False)
                    .numpy().astype(int)).max() for f in frames]
    record_property("jpeg_max_abs_diff", int(max(diffs)))
    assert max(diffs) <= 1


def _transforms(seed=0):
    from vla_adapter_torch.data.action_tokenizer import (
        ActionTokenizer as TActionTokenizer,
    )
    from vla_adapter_torch.data.image_processing import (
        image_processor_for as t_proc,
    )
    from vla_adapter_torch.data.tokenization import (
        MockTokenizer as TMock,
        TextToIds,
    )
    from vla_adapter_torch.data.transform import (
        VLABatchTransform as TTransform,
    )
    from vla_adapter_tpu.data.action_tokenizer import (
        ActionTokenizer as JActionTokenizer,
    )
    from vla_adapter_tpu.data.image_processing import (
        image_processor_for as j_proc,
    )
    from vla_adapter_tpu.data.tokenization import MockTokenizer as JMock
    from vla_adapter_tpu.data.transform import VLABatchTransform as JTransform

    jtok, ttok = JMock(length=VOCAB), TMock(length=VOCAB)
    jt = JTransform(JCFG, lambda s: jtok(s).input_ids,
                    JActionTokenizer(len(jtok)),
                    image_processor=j_proc(JCFG.vision), seed=seed)
    tt = TTransform(TCFG, TextToIds(ttok), TActionTokenizer(len(ttok)),
                    image_processor=t_proc(TCFG.vision), seed=seed)
    return jt, tt


# one uint8 level after the processor: 1/255 over the smallest std
PIXEL_ATOL = 1.0 / (255 * 0.2236328125) + 1e-6


def assert_batches(got, want):
    assert set(got) == set(want)
    for k in ("input_ids", "labels", "text_valid", "prompt_len"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(got["dataset_name"]) == list(want["dataset_name"])
    for k in ("actions", "proprio"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"],
                               rtol=0, atol=PIXEL_ATOL)


def _datasets(cls_pair=("RLDSDataset", "RLDSDataset"), trajs=TRAJS,
              **kw):
    jt, tt = _transforms()
    jkw, tkw = kwargs_pair(trajs)
    want = getattr(jrd, cls_pair[0])(JCFG, jt, [jkw], train=False,
                                     image_aug=False, **kw)
    got = getattr(trd, cls_pair[1])(TCFG, tt, [tkw], train=False,
                                    image_aug=False, **kw)
    return got, want


def test_rlds_dataset_batches_match_jax():
    got, want = _datasets(batch_size=3)
    assert got.dataset_statistics == want.dataset_statistics
    gb, wb = list(got), list(want)
    assert len(gb) == len(wb) > 5
    for g, w in zip(gb, wb):
        assert_batches(g, w)
        assert g["pixel_values"].shape == (3, 2, 28, 28, 6)


def test_rlds_dataset_accumulation_layout():
    got, want = _datasets(batch_size=4, accum_steps=2)
    g, w = next(iter(got)), next(iter(want))
    assert g["input_ids"].shape == (2, 2, TCFG.max_text_tokens)
    assert_batches(g, w)


def test_episodic_dataset_same_episodes():
    got, want = _datasets(("EpisodicRLDSDataset", "EpisodicRLDSDataset"))
    ge, we = list(got), list(want)
    assert [len(e) for e in ge] == [len(e) for e in we]
    assert sorted(len(e) for e in ge) == sorted(
        len(t["action"]) - FUTURE for t in TRAJS)
    from vla_adapter_torch.data.collator import collate

    for g, w in zip(ge, we):
        assert_batches(collate(g), collate(w))


def _mixture(train, weights, seed=0):
    other = libero_trajs(seed=1, num=3)
    jkw0, tkw0 = kwargs_pair()
    jkw1, tkw1 = kwargs_pair(other, name="libero_object_no_noops")
    traj = dict(window_size=1, future_action_window_size=FUTURE,
                skip_unlabeled=True)
    frame = dict(resize_size={})  # decode only: the images are not compared
    got, stats = tds.make_interleaved_dataset(
        [tkw0, tkw1], weights, train=train, shuffle_buffer_size=64,
        traj_transform_kwargs=traj, frame_transform_kwargs=frame, seed=seed)
    want, jstats = jds.make_interleaved_dataset(
        [jkw0, jkw1], weights, train=train, shuffle_buffer_size=64,
        traj_transform_kwargs=traj, frame_transform_kwargs=frame)
    assert stats == jstats
    return got, want, other


def _frame_key(fr):
    return (bytes(fr["dataset_name"]), int(fr["observation"]["timestep"][0]),
            fr["action"].tobytes())


def test_interleaved_mixture_frames_and_proportions():
    got, want, other = _mixture(False, [3.0, 1.0])
    g = sorted(map(_frame_key, got))
    w = sorted(map(_frame_key, want.as_numpy_iterator()))
    assert g == w and len(g) == sum(
        len(t["action"]) - FUTURE for t in TRAJS + other)
    # training: 2,000 draws within a binomial bound (4 sigma) of 3:1
    got, _, _ = _mixture(True, [3.0, 1.0], seed=7)
    names = [bytes(f["dataset_name"]) for _, f in zip(range(2000), got)]
    share = names.count(b"libero_spatial_no_noops") / len(names)
    assert abs(share - 0.75) <= 4 * np.sqrt(0.75 * 0.25 / len(names))
    assert len(set(names)) == 2


def test_workers_take_disjoint_shares():
    """Every worker's share of the trajectories (train=False) is disjoint
    and together they are the whole; with repeat and shuffle (train=True)
    no frame of one worker's stream appears in another's."""
    _, tt = _transforms()
    _, tkw = kwargs_pair()
    for train in (False, True):
        ds = trd.RLDSDataset(TCFG, tt, [tkw], train=train, image_aug=False,
                             batch_size=1, shuffle_buffer_size=16)
        shares = []
        for w in range(2):
            frames = ds.pipeline(w, 2)
            take = frames if not train else (f for _, f in zip(range(60),
                                                               frames))
            shares.append({_frame_key(f) for f in take})
        assert shares[0] and shares[1] and not shares[0] & shares[1]
        if not train:
            whole = {_frame_key(f) for f in ds.pipeline()}
            assert shares[0] | shares[1] == whole


def test_data_loader_with_two_spawn_workers():
    """Through DataLoader(num_workers=2, spawn): the batches of both
    workers together hold every frame once (train=False, batch 1)."""
    _, tt = _transforms()
    _, tkw = kwargs_pair()
    ds = trd.RLDSDataset(TCFG, tt, [tkw], train=False, image_aug=False,
                         batch_size=1)
    rows = [b["proprio"][0].tobytes()
            for b in trd.data_loader(ds, num_workers=2)]
    alone = [b["proprio"][0].tobytes() for b in trd.data_loader(ds)]
    assert len(rows) == len(set(rows)) == len(alone)
    assert set(rows) == set(alone)


def test_statistics_cache_under_the_port_home(tmp_path):
    """With a data_dir the statistics are cached under
    ~/.cache/vla_adapter_torch, keyed as the JAX package keys them, and
    read back from there."""
    j = j_oxe_kwargs("libero_spatial_no_noops", "/data",
                     load_camera_views=("primary", "wrist"))
    t = t_oxe_kwargs("libero_spatial_no_noops", "/data",
                     load_camera_views=("primary", "wrist"))
    _, jstats = jds.make_dataset_from_rlds(train=True,
                                           traj_dataset=tf_source(TRAJS), **j)
    _, tstats = tds.make_dataset_from_rlds(train=True, traj_source=TRAJS,
                                           **t)
    assert tstats == jstats
    jfiles = sorted((tmp_path / ".cache" / "vla_adapter_tpu").iterdir())
    tfiles = sorted((tmp_path / ".cache" / "vla_adapter_torch").iterdir())
    assert len(tfiles) == 1
    assert tfiles[0].name.replace("_torch", "") == jfiles[0].name \
        .replace("_tpu", "")
    # a cached file wins over the source
    _, again = tds.make_dataset_from_rlds(train=True,
                                          traj_source=TRAJS[:1], **t)
    assert again == tstats


def test_tfds_reader_without_tensorflow_datasets(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", None)
    with pytest.raises(ImportError, match="tensorflow_datasets"):
        tds.load_tfds_trajectories("libero_spatial_no_noops", "/data",
                                   train=True, shuffle=True)
    _, tkw = kwargs_pair()
    tkw.pop("traj_source")
    with pytest.raises(ImportError, match="tensorflow_datasets"):
        tds.make_dataset_from_rlds(train=True, **tkw)


def test_batches_without_tensorflow():
    """A process where ``import tensorflow`` fails builds training batches
    (augmentation on, repeat and shuffle) from an in-memory source: nothing
    past the TFDS reader needs TensorFlow."""
    code = """
import sys
sys.modules["tensorflow"] = None
sys.modules["tensorflow_datasets"] = None
import numpy as np
from chip_smoke import synthetic_libero_trajectories
from tests.torch_tiny import tiny_cfg
import vla_adapter_torch.core.config as tc, vla_adapter_torch.core.constants as tk
from vla_adapter_torch.data.action_tokenizer import ActionTokenizer
from vla_adapter_torch.data.image_processing import image_processor_for
from vla_adapter_torch.data.rlds.oxe.materialize import make_oxe_dataset_kwargs
from vla_adapter_torch.data.rlds_dataset import RLDSDataset
from vla_adapter_torch.data.tokenization import MockTokenizer, TextToIds
from vla_adapter_torch.data.transform import VLABatchTransform
cfg = tiny_cfg(tc, tk)
tok = MockTokenizer(length=cfg.llm.vocab_size)
kw = make_oxe_dataset_kwargs("libero_spatial_no_noops", "/unused",
                             load_camera_views=("primary", "wrist"))
kw.update(data_dir=None, traj_source=synthetic_libero_trajectories(
    0, 3, lengths=(12, 16), image_size=64, pool=4))
ds = RLDSDataset(cfg, VLABatchTransform(cfg, TextToIds(tok),
                 ActionTokenizer(len(tok)),
                 image_processor=image_processor_for(cfg.vision)),
                 [kw], batch_size=4, train=True, image_aug=True,
                 shuffle_buffer_size=32)
it = iter(ds)
for _ in range(3):
    b = next(it)
assert b["pixel_values"].shape == (4, 2, 28, 28, 6), b["pixel_values"].shape
assert np.isfinite(b["pixel_values"]).all()
assert "tensorflow" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


SLICE_MODULES = (
    "data/normalization.py", "data/transform.py", "data/rlds_dataset.py",
    "data/batching.py", "data/download.py", "data/vlm_datasets.py",
    "data/rlds/dataset.py", "data/rlds/obs_transforms.py",
    "data/rlds/traj_transforms.py", "data/rlds/utils/goal_relabeling.py",
    "data/rlds/utils/task_augmentation.py", "data/rlds/oxe/configs.py",
    "data/rlds/oxe/mixtures.py", "data/rlds/oxe/transforms.py",
    "data/rlds/oxe/materialize.py", "train/finetune.py")


def test_only_the_tfds_reader_imports_tensorflow():
    """A static scan of the RLDS modules: tensorflow and
    tensorflow_datasets are imported only inside load_tfds_trajectories,
    and nothing imports them, jax or the JAX package at module level."""
    import ast

    bad = []
    for rel in SLICE_MODULES:
        path = ROOT / "vla_adapter_torch" / rel
        tree = ast.parse(path.read_text())
        owner = {}
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    owner.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "flax", "vla_adapter_tpu"):
                    bad.append(f"{rel}:{node.lineno} {name}")
                if top in ("tensorflow", "tensorflow_datasets") and (
                        owner.get(id(node)) != "load_tfds_trajectories"):
                    bad.append(f"{rel}:{node.lineno} {name}")
    assert not bad, bad
