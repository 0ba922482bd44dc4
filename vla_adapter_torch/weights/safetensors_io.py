"""The safetensors format, read and written without the ``safetensors``
package (which the card machine does not have).

A file is an 8-byte little-endian header length N, N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`` (padded with spaces to a multiple of 8), then the tensors'
raw little-endian bytes; offsets count from the end of the header.

:func:`load_file` maps the file and views each tensor in place
(``torch.frombuffer`` over a private copy-on-write mapping): nothing is
copied until a tensor is moved or written.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors viewing a
    mapping of the file."""
    with open(path, "rb") as f:
        size = Path(path).stat().st_size
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes past the end")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = (8 + n + o for o in info["data_offsets"])
        numel = 1
        for dim in shape:
            numel *= dim
        if end - begin != numel * dtype.itemsize or end > size:
            raise ValueError(f"{path}: {name} {shape} {info['dtype']} spans "
                             f"bytes {begin}-{end} of {size}")
        out[name] = (torch.frombuffer(buf, dtype=dtype, count=numel,
                                      offset=begin).view(shape) if numel
                     else torch.empty(shape, dtype=dtype))
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path,
              metadata: Optional[Mapping[str, str]] = None) -> Path:
    """Write ``tensors`` (any device; stored contiguous, in name order) as
    one safetensors file."""
    names = sorted(tensors)
    return write_file({n: (tensors[n].dtype, tuple(tensors[n].shape))
                       for n in names}, (tensors[n] for n in names), path,
                      metadata)


def write_file(specs: Mapping[str, Tuple[torch.dtype, Sequence[int]]],
               tensors: Iterable[torch.Tensor], path,
               metadata: Optional[Mapping[str, str]] = None) -> Path:
    """Write one safetensors file whose header is ``specs`` (name ->
    (dtype, shape)) and whose tensors ``tensors`` yields one at a time, in
    name order, each of its spec's dtype and shape: each is copied to the
    host, written and dropped before the next is asked for, so a state
    made tensor by tensor (a checkpoint gathered from its shards) is never
    whole in memory."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    names = sorted(specs)
    offset = 0
    for name in names:
        dtype, shape = specs[name]
        if dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {dtype} is not one of "
                             f"{sorted(DTYPES)}")
        numel = 1
        for dim in shape:
            numel *= dim
        nbytes = numel * dtype.itemsize
        header[name] = {"dtype": _NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    path = Path(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        made = iter(tensors)
        for name in names:
            t = next(made, None)
            got = None if t is None else (t.dtype, tuple(t.shape))
            if got != (specs[name][0], tuple(specs[name][1])):
                raise ValueError(f"{path}: {name} is {got}, its header "
                                 f"says {specs[name]}")
            t = t.detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
            del t
        if next(made, None) is not None:
            raise ValueError(f"{path}: more tensors than the header's "
                             f"{len(names)}")
    return path
