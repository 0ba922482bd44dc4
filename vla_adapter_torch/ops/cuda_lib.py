"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``vla_adapter_torch/csrc/`` exposes a plain C
function. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``vla_adapter_torch/_build/`` (named by a hash of the
source, the ``csrc/`` headers it includes and the flags, so an edit to any
of them rebuilds) and loaded with ``ctypes``. No PyTorch headers are
included, so a build takes seconds, not minutes.

``LAUNCHES`` counts kernel launches by kernel name: every wrapper calls
:func:`count_launch` where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels. Inside
:func:`recording` (a CUDA graph's warm-up and capture) the count goes to
the recording's own ``Counter`` instead, and whoever replays the graph
adds that ``Counter`` to ``LAUNCHES`` at each replay
(:func:`add_launches`), so the counts per request stay those of an eager
run. Both update ``LAUNCHES`` under a lock, so that the counts of requests
served from several threads at once (a server) are not lost.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOGS: dict = {}
_LIBS: dict = {}
_LOCK = threading.Lock()
_SOURCE_LOCKS: dict = collections.defaultdict(threading.Lock)


_RECORDING = threading.local()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: into this thread's :func:`recording`
    if one is open, or else into ``LAUNCHES``."""
    counter = getattr(_RECORDING, "counter", None)
    if counter is not None:
        counter[name] += 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def add_launches(counts) -> None:
    """Add a graph's recorded launches to ``LAUNCHES`` (one replay)."""
    with _COUNT_LOCK:
        LAUNCHES.update(counts)


@contextlib.contextmanager
def recording():
    """Count this thread's launches into a fresh ``Counter`` (yielded)
    instead of ``LAUNCHES``."""
    outer = getattr(_RECORDING, "counter", None)
    _RECORDING.counter = counter = collections.Counter()
    try:
        yield counter
    finally:
        _RECORDING.counter = outer


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of a CUDA device, which the kernels' plans size grids by."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "compiled at first use")
    return found


def _with_includes(name: str, seen: set) -> bytes:
    """The bytes of ``csrc/<name>`` followed by those of every ``csrc/``
    file it includes with ``#include "..."``, depth first, each once."""
    if name in seen:
        return b""
    seen.add(name)
    text = (CSRC_DIR / name).read_bytes()
    return text + b"".join(_with_includes(inc.decode(), seen)
                           for inc in _INCLUDE.findall(text))


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` is built: named by a hash of the source, the
    headers it includes and the nvcc flags."""
    digest = hashlib.sha256(_with_includes(source, set())
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    with _LOCK:
        lock = _SOURCE_LOCKS[source]
    with lock:
        if source in _LIBS:
            return _LIBS[source]
        src = CSRC_DIR / source
        lib_path = library_path(source)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, check=False)
            BUILD_LOGS[source] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _LIBS[source] = lib
        return lib


def load_libraries(sources) -> dict:
    """Compile several sources at once (one nvcc each, all started
    together) and load them: {source: library}."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(load_library, sources)))
