"""VLM-pretraining dataset fetch/prepare CLI (copy of
vla_adapter_tpu/data/vlm_datasets.py).

Covers the reference's LLaVA data tooling (scripts/preprocess.py +
prismatic/preprocessing/download.py:32-207): a registry of the LLaVA v1.5
dataset components (align-stage chat.json + images; finetune-stage
mix665k + COCO/GQA/OCR-VQA/TextVQA/VisualGenome image sets), a
download-and-extract step, and the OCR-VQA GIF/PNG -> JPG conversion the
finetune stage needs. Network-gated like data/download.py — zero-egress
environments stage the files by other means and still use the extract +
convert paths.

    python -m vla_adapter_torch.data.vlm_datasets \
        --dataset_id llava-laion-cc-sbu-558k --root_dir data
"""

from __future__ import annotations

import dataclasses
import shutil
import tarfile
import urllib.request
from pathlib import Path
from typing import Dict, List
from zipfile import ZipFile

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)

# Factual registry of the public LLaVA v1.5 artifacts (same sources the
# reference pulls — prismatic/preprocessing/download.py:32-105).
# name: final path under <root>/download/<dataset_id>/ ;
# extract: archive vs plain file; rename: move the extracted/downloaded
# path to `name` (archives whose top-level dir differs from `name`).
DATASET_REGISTRY: Dict[str, List[Dict]] = {
    "llava-laion-cc-sbu-558k": [
        {"name": "chat.json", "extract": False, "rename": True,
         "url": ("https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/"
                 "resolve/main/blip_laion_cc_sbu_558k.json")},
        {"name": "images", "extract": True, "rename": False,
         "url": ("https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/"
                 "resolve/main/images.zip")},
    ],
    # Raw inputs for the instruct-tuning merge builders below. LRV ships via
    # Google Drive (reference scripts/additional-datasets/lrv_instruct.py
    # header lists the ids) — "gdrive:" entries cannot be fetched by plain
    # HTTP here; stage them manually and the builders pick them up.
    "lvis-instruct-4v": [
        {"name": "lvis_instruct4v_220k.json", "extract": False, "rename": True,
         "url": ("https://huggingface.co/datasets/X2FD/LVIS-Instruct4V/"
                 "resolve/main/lvis_instruct4v_220k.json")},
    ],
    "lrv-instruct": [
        {"name": "filter_cap1.json", "extract": False, "rename": True,
         "url": "gdrive:1pWkxE2kqpys1VdwBi99ZXN6-XY5SqhwU"},
        {"name": "filter_cap_more1.json", "extract": False, "rename": True,
         "url": "gdrive:1NTxkuRPlvDn7aWaJpK_yb0p5r0cxPLNZ"},
        {"name": "chart_release_update.json", "extract": False, "rename": True,
         "url": "gdrive:13j2U-ectsYGR92r6J5hPdhT8T5ezItHF"},
        {"name": "lrv-vg", "extract": True, "rename": True,
         "url": "gdrive:1k9MNV-ImEV9BYEOeLEIb4uGEUZjd3QbM"},
        {"name": "lrv-chart", "extract": True, "rename": True,
         "url": "gdrive:1Dey-undzW2Nl21CYLFSkP_Y4RrfRJkYd"},
    ],
    "llava-v1.5-instruct": [
        {"name": "llava_v1_5_mix665k.json", "extract": False, "rename": True,
         "url": ("https://huggingface.co/datasets/liuhaotian/"
                 "LLaVA-Instruct-150K/resolve/main/llava_v1_5_mix665k.json")},
        {"name": "coco/train2017", "extract": True, "rename": True,
         "url": "http://images.cocodataset.org/zips/train2017.zip"},
        {"name": "gqa/images", "extract": True, "rename": True,
         "url": "https://downloads.cs.stanford.edu/nlp/data/gqa/images.zip"},
        {"name": "ocr_vqa/images", "extract": True, "rename": True,
         "url": ("https://huggingface.co/datasets/qnguyen3/ocr_vqa/"
                 "resolve/main/ocr_vqa.zip")},
        {"name": "textvqa/train_images", "extract": True, "rename": True,
         "url": ("https://dl.fbaipublicfiles.com/textvqa/images/"
                 "train_val_images.zip")},
        {"name": "vg/VG_100K", "extract": True, "rename": True,
         "url": "https://cs.stanford.edu/people/rak248/VG_100K_2/images.zip"},
        {"name": "vg/VG_100K_2", "extract": True, "rename": True,
         "url": "https://cs.stanford.edu/people/rak248/VG_100K_2/images2.zip"},
    ],
}


def download_file(url: str, dest_dir: Path) -> Path:
    """Fetch url into dest_dir (skips if present). Network-gated."""
    if url.startswith("gdrive:"):
        raise RuntimeError(
            f"{url} is Google-Drive-hosted (no direct HTTP URL); stage it "
            f"manually into {dest_dir} (reference uses `gdown {url[7:]}`)")
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / Path(url).name
    if dest.exists():
        log.info("already downloaded: %s", dest)
        return dest
    log.info("downloading %s -> %s", url, dest)
    tmp = dest.with_suffix(dest.suffix + ".part")
    with urllib.request.urlopen(url) as resp, open(tmp, "wb") as f:
        shutil.copyfileobj(resp, f, length=1 << 20)
    tmp.rename(dest)
    return dest


def extract_archive(archive: Path, dest_dir: Path) -> Path:
    """Extract a .zip / .tar(.gz) archive; returns the top-level extracted
    path (dir for multi-member archives, the file itself otherwise)."""
    log.info("extracting %s", archive.name)
    if archive.suffix == ".zip":
        with ZipFile(archive) as zf:
            names = zf.namelist()
            zf.extractall(dest_dir)
    elif archive.suffix in (".tar", ".gz", ".tgz") or archive.name.endswith(
            ".tar.gz"):
        with tarfile.open(archive) as tf:
            names = tf.getnames()
            tf.extractall(dest_dir, filter="data")
    else:
        raise ValueError(f"unsupported archive type: {archive.name}")
    top = dest_dir / names[0].split("/")[0]
    return top


def download_extract(dataset_id: str, root_dir, cleanup: bool = False) -> Path:
    """Materialize every component of a registered dataset under
    <root_dir>/download/<dataset_id>/ (reference download.py:191-207)."""
    assert dataset_id in DATASET_REGISTRY, (
        f"unknown dataset {dataset_id!r}; known: {sorted(DATASET_REGISTRY)}")
    download_dir = Path(root_dir) / "download" / dataset_id
    download_dir.mkdir(parents=True, exist_ok=True)

    for comp in DATASET_REGISTRY[dataset_id]:
        final = download_dir / comp["name"]
        if final.exists():
            log.info("present: %s", final)
            continue
        path = download_file(comp["url"], download_dir)
        if comp["extract"]:
            extracted = extract_archive(path, download_dir)
            if cleanup:
                path.unlink()
            path = extracted
        if comp["rename"] and path != final:
            final.parent.mkdir(parents=True, exist_ok=True)
            shutil.move(str(path), str(final))
    return download_dir


def convert_images_to_jpg(image_dir) -> int:
    """GIF/PNG -> JPG conversion for OCR-VQA (reference download.py:109-124):
    GIFs take frame 0; existing .jpg/.jpeg (or already-converted stems) are
    skipped. Returns the number of files converted."""
    from PIL import Image

    image_dir = Path(image_dir)
    converted = 0
    for fn in sorted(image_dir.iterdir()):
        jpg = image_dir / f"{fn.stem}.jpg"
        if fn.suffix in (".jpg", ".jpeg") or jpg.exists():
            continue
        if fn.suffix == ".gif":
            gif = Image.open(fn)
            gif.seek(0)
            gif.convert("RGB").save(jpg)
        elif fn.suffix == ".png":
            Image.open(fn).convert("RGB").save(jpg)
        else:
            raise ValueError(f"unexpected image format {fn.suffix!r} ({fn})")
        converted += 1
    log.info("converted %d images in %s", converted, image_dir)
    return converted


# --- instruct-tuning merge builders -----------------------------------------
# Reference scripts/additional-datasets/{lvis_instruct_4v,lrv_instruct}.py:
# convert the raw LVIS-Instruct4V / LRV-Instruct JSONs into LLaVA chat
# format and merge them with the LLaVA v1.5 mixes, producing the JSONs
# behind the llava-lvis4v / llava-lrv / llava-lvis4v-lrv model configs
# (models/zoo.py:112-114). Semantics kept exactly — random.seed(7) and a
# triple shuffle — so the output files are byte-reproducible given the
# same inputs.


def _seeded_triple_shuffle(data: List[dict]) -> List[dict]:
    import random

    random.seed(7)
    for _ in range(3):
        random.shuffle(data)
    return data


def lrv_to_llava_chat(vg_examples: List[dict],
                      chart_examples: List[dict]) -> List[dict]:
    """Raw LRV records -> LLaVA chat entries (lrv_instruct.py:95-145).
    VG rows key images by bare image_id (lrv-vg/<id>.jpg); chart rows carry
    a relative file name (lrv-chart/<file>)."""
    out = []
    for ex in vg_examples:
        out.append({
            "id": ex["image_id"],
            "image": f"lrv/lrv-vg/{ex['image_id']}.jpg",
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{ex['question'].strip()}"},
                {"from": "gpt", "value": ex["answer"].strip()},
            ],
        })
    for ex in chart_examples:
        out.append({
            "id": Path(ex["image_id"]).stem,
            "image": f"lrv/lrv-chart/{ex['image_id']}",
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{ex['question'].strip()}"},
                {"from": "gpt", "value": ex["answer"].strip()},
            ],
        })
    return out


def _verify_images(entries: List[dict], base_dir: Path, what: str) -> None:
    missing = [e["image"] for e in entries
               if "image" in e and not (base_dir / e["image"]).exists()]
    assert not missing, (
        f"{what}: {len(missing)} referenced images missing under {base_dir} "
        f"(first: {missing[:3]})")


def build_lvis_instruct_4v(base_dir, verify_images: bool = True) -> Path:
    """lvis_instruct4v_220k.json + mix665k -> llava_v1_5_lvis4v_mix888k.json
    (reference lvis_instruct_4v.py:40-74). `base_dir` is the
    llava-v1.5-instruct download dir holding both inputs (the LVIS JSON is
    staged there from the lvis-instruct-4v registry entry)."""
    import json

    base_dir = Path(base_dir)
    with open(base_dir / "lvis_instruct4v_220k.json") as f:
        lvis = json.load(f)
    if verify_images:
        _verify_images(lvis, base_dir, "LVIS-Instruct4V")
    with open(base_dir / "llava_v1_5_mix665k.json") as f:
        base = json.load(f)
    merged = _seeded_triple_shuffle(base + lvis)
    out = base_dir / "llava_v1_5_lvis4v_mix888k.json"
    with open(out, "w") as f:
        json.dump(merged, f)
    log.info("wrote %s (%d examples)", out, len(merged))
    return out


def build_lrv_instruct(base_dir, verify_images: bool = True) -> List[Path]:
    """LRV VG+chart JSONs -> LLaVA chat, merged into
    llava_v1_5_lrv_mix1008k.json (over mix665k) and
    llava_v1_5_lvis4v_lrv_mix1231k.json (over the lvis4v 888k mix)
    (reference lrv_instruct.py:62-148). Raw LRV inputs live under
    <base_dir>/lrv/ (stage via the lrv-instruct registry entry)."""
    import json

    base_dir = Path(base_dir)
    lrv_dir = base_dir / "lrv"
    vg = []
    for fn in ("filter_cap1.json", "filter_cap_more1.json"):
        with open(lrv_dir / fn) as f:
            vg.extend(json.load(f))
    with open(lrv_dir / "chart_release_update.json") as f:
        chart = json.load(f)
    lrv_data = lrv_to_llava_chat(vg, chart)
    if verify_images:
        _verify_images(lrv_data, base_dir, "LRV-Instruct")

    outs = []
    for base_json, out_name in (
        ("llava_v1_5_mix665k.json", "llava_v1_5_lrv_mix1008k.json"),
        ("llava_v1_5_lvis4v_mix888k.json",
         "llava_v1_5_lvis4v_lrv_mix1231k.json"),
    ):
        if not (base_dir / base_json).exists():
            # The 1231k merge stacks on the lvis4v build's 888k output
            # (reference lrv_instruct.py:53 assumes it was run first). A
            # standalone `--build lrv` still produces the 1008k mix instead
            # of dying after it.
            log.warning("skipping %s: base %s not found (run --build "
                        "lvis4v or lvis4v-lrv first)", out_name, base_json)
            continue
        with open(base_dir / base_json) as f:
            base = json.load(f)
        merged = _seeded_triple_shuffle(base + lrv_data)
        out = base_dir / out_name
        with open(out, "w") as f:
            json.dump(merged, f)
        log.info("wrote %s (%d examples)", out, len(merged))
        outs.append(out)
    return outs


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    dataset_id: str = "llava-v1.5-instruct"
    root_dir: str = "data"
    cleanup_archives: bool = False
    # "" | "lvis4v" | "lrv" | "lvis4v-lrv": run the instruct-tuning merge
    # builder(s) after download (inputs must be staged first)
    build: str = ""


def main(argv=None) -> None:
    cfg = parse_config(PreprocessConfig, argv)
    out = download_extract(cfg.dataset_id, cfg.root_dir,
                           cleanup=cfg.cleanup_archives)
    if cfg.dataset_id == "llava-v1.5-instruct":
        # OCR-VQA ships GIFs/PNGs; the chat JSON references .jpg paths
        convert_images_to_jpg(out / "ocr_vqa" / "images")
    instruct_dir = Path(cfg.root_dir) / "download" / "llava-v1.5-instruct"
    if cfg.build in ("lvis4v", "lvis4v-lrv"):
        build_lvis_instruct_4v(instruct_dir)
    if cfg.build in ("lrv", "lvis4v-lrv"):
        build_lrv_instruct(instruct_dir)
    log.info("dataset ready at %s", out)


if __name__ == "__main__":
    main()
