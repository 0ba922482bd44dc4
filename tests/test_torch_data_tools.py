"""The port's VLM data tools against the JAX package's, on the CPU:
``SplitModalitySampler`` index for index over three epochs, the download
CLI's dry run (the same commands logged, no process started), and the
local-file steps of ``vlm_datasets`` (archive extraction, the GIF/PNG ->
JPG conversion, the LRV and LVIS-Instruct4V merge builders) on fixtures
under tmp_path, with outputs equal byte for byte.
"""

import json
import logging
import tarfile
import zipfile

import numpy as np
import pytest
from PIL import Image

from vla_adapter_torch.data import batching as tbatch
from vla_adapter_torch.data import download as tdownload
from vla_adapter_torch.data import vlm_datasets as tvlm
from vla_adapter_tpu.data import batching as jbatch
from vla_adapter_tpu.data import download as jdownload
from vla_adapter_tpu.data import vlm_datasets as jvlm


@pytest.mark.parametrize("batch_size,seed", [(4, 0), (3, 7), (16, 1)])
def test_split_modality_sampler_matches_jax(batch_size, seed):
    rng = np.random.default_rng(seed)
    n = 173
    mm = rng.random(n) < 0.7
    lengths = rng.integers(5, 300, size=n)
    got = tbatch.SplitModalitySampler(mm, lengths, batch_size, seed=seed)
    want = jbatch.SplitModalitySampler(mm, lengths, batch_size, seed=seed)
    assert len(got) == len(want)
    for epoch in range(3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g, w = list(got), list(want)
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert len(set(mm[a])) == 1  # one modality per batch


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(module, argv):
    handler = _Messages()
    module.log.addHandler(handler)
    try:
        module.main(argv)
    finally:
        module.log.removeHandler(handler)
    return handler.lines


@pytest.mark.parametrize("mixture", ["libero_4_task_suites_no_noops",
                                     "bridge_rt_1"])
def test_download_dry_run_matches_jax(monkeypatch, mixture):
    import subprocess

    def refuse(*a, **k):
        raise AssertionError("the dry run started a process")

    monkeypatch.setattr(subprocess, "run", refuse)
    argv = ["--dry_run", "true", "--mixture", mixture,
            "--data_root_dir", "/data/rlds"]
    got, want = _logged(tdownload, argv), _logged(jdownload, argv)
    assert got == want
    assert any(line.startswith("gsutil -m cp -r gs://") for line in got)


def _png(path, seed, size=(6, 5)):
    arr = np.random.default_rng(seed).integers(0, 256, (*size[::-1], 3),
                                               dtype=np.uint8)
    Image.fromarray(arr).save(path)


def _fixtures(root):
    """Archives, images and chat JSONs as the builders read them."""
    src = root / "src"
    (src / "pack").mkdir(parents=True)
    (src / "pack" / "a.txt").write_text("alpha")
    (src / "pack" / "b.txt").write_text("beta")
    with tarfile.open(root / "pack.tar", "w") as tar:
        tar.add(src / "pack", arcname="pack")
    with zipfile.ZipFile(root / "pack.zip", "w") as zf:
        zf.write(src / "pack" / "a.txt", "zpack/a.txt")
        zf.write(src / "pack" / "b.txt", "zpack/b.txt")
    images = root / "images"
    images.mkdir()
    for i in range(3):
        _png(images / f"p{i}.png", i)
    frames = [Image.fromarray(np.full((5, 6, 3), 40 * k, np.uint8))
              for k in range(3)]
    frames[0].save(images / "g.gif", save_all=True, append_images=frames[1:])
    _png(root / "x.png", 9)
    Image.open(root / "x.png").convert("RGB").save(images / "done.jpg")

    base = root / "instruct"
    (base / "lrv").mkdir(parents=True)
    chat = lambda i: {"id": f"c{i}", "image": f"coco/{i}.jpg",  # noqa: E731
                      "conversations": [{"from": "human", "value": "q"},
                                        {"from": "gpt", "value": "a"}]}
    (base / "llava_v1_5_mix665k.json").write_text(
        json.dumps([chat(i) for i in range(7)]))
    (base / "lvis_instruct4v_220k.json").write_text(
        json.dumps([dict(chat(i), id=f"l{i}") for i in range(5)]))
    vg = [{"image_id": str(100 + i), "question": f" q{i} ",
           "answer": f" a{i} "} for i in range(4)]
    (base / "lrv" / "filter_cap1.json").write_text(json.dumps(vg[:2]))
    (base / "lrv" / "filter_cap_more1.json").write_text(json.dumps(vg[2:]))
    (base / "lrv" / "chart_release_update.json").write_text(json.dumps(
        [{"image_id": "charts/c1.png", "question": "q", "answer": "a"}]))
    return base


def test_vlm_dataset_local_steps_match_jax(tmp_path):
    """Each package runs the same steps on its own copy of the fixtures;
    the port's outputs must equal the JAX package's."""
    outputs = {}
    for name, mod in (("jax", jvlm), ("port", tvlm)):
        root = tmp_path / name
        base = _fixtures(root)
        out = {}
        top = mod.extract_archive(root / "pack.tar", root / "x_tar")
        out["tar"] = (top.name, sorted(p.name for p in top.iterdir()))
        top = mod.extract_archive(root / "pack.zip", root / "x_zip")
        out["zip"] = (top.name, sorted(p.name for p in top.iterdir()))
        with pytest.raises(ValueError, match="unsupported"):
            mod.extract_archive(root / "x.png", root / "x_bad")
        out["converted"] = mod.convert_images_to_jpg(root / "images")
        out["jpgs"] = {p.name: p.read_bytes()
                       for p in sorted((root / "images").glob("*.jpg"))}
        out["lvis"] = mod.build_lvis_instruct_4v(
            base, verify_images=False).read_bytes()
        paths = mod.build_lrv_instruct(base, verify_images=False)
        out["lrv"] = [(p.name, p.read_bytes()) for p in paths]
        out["chat"] = mod.lrv_to_llava_chat(
            [{"image_id": "7", "question": " q ", "answer": " a "}],
            [{"image_id": "d/e.png", "question": "q", "answer": "a"}])
        with pytest.raises(AssertionError, match="missing"):
            mod.build_lvis_instruct_4v(base, verify_images=True)
        outputs[name] = out
    got, want = outputs["port"], outputs["jax"]
    assert got == want
    assert got["converted"] == 4 and len(got["lrv"]) == 2
    assert got["tar"] == ("pack", ["a.txt", "b.txt"])


def test_vlm_download_refuses_drive_ids(tmp_path):
    """A Google-Drive entry has no HTTP URL: refused before any fetch."""
    with pytest.raises(RuntimeError, match="Google-Drive"):
        tvlm.download_file("gdrive:abc", tmp_path)
    assert set(tvlm.DATASET_REGISTRY) == set(jvlm.DATASET_REGISTRY)
    assert tvlm.DATASET_REGISTRY == jvlm.DATASET_REGISTRY
