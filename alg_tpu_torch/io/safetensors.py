"""The safetensors format, read and written with torch alone.

A file is an 8-byte little-endian header length, a JSON header that maps each
tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (begin, end
within the data section; an optional ``__metadata__`` entry holds strings),
and then the raw little-endian data. The reader reads each file's data in
one sequential read into one host buffer and returns tensors that are views
of that buffer: a bf16 shard stays bf16 bit for bit, and the host holds one
copy of the shards being loaded, freed with their tensors. (A memory map
would hold none, but a map faults its pages in one at a time, which on a
network or overlay file system is slower than the read by an order of
magnitude.) The ``safetensors`` package is not needed.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}


def read_header(path: str):
    """``(header dict, byte offset of the data section)`` of one file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, by name. On the CPU the
    tensors are views of one buffer that holds the file's data (a tensor
    whose offset is not a multiple of its element size is copied out
    instead); on another ``device`` each is copied there."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    buf = torch.empty(os.path.getsize(path) - start, dtype=torch.uint8)
    with open(path, "rb") as f:
        f.seek(start)
        view, got = memoryview(buf.numpy()), 0
        while got < len(view):
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: the file ends {len(view) - got} bytes early")
            got += n
    out = {}
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = dtype.itemsize
        if end - begin != itemsize * torch.Size(shape).numel():
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, not {shape} of {info['dtype']}")
        raw = buf[begin:end]
        if begin % itemsize:  # a misaligned view of the buffer is refused
            raw = raw.clone()
        t = raw.view(dtype).view(shape)
        out[name] = t if torch.device(device).type == "cpu" else t.to(device)
    return out


def load_safetensors_dir(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file under ``path``, in sorted order, as one
    name -> tensor dict (a name in two shards raises)."""
    state: Dict[str, torch.Tensor] = {}
    for fname in sorted(f for f in os.listdir(path) if f.endswith(".safetensors")):
        for name, t in load_file(os.path.join(path, fname), device).items():
            if name in state:
                raise ValueError(f"{path}: tensor {name!r} is in more than one shard")
            state[name] = t
    return state


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device; written contiguous, little-endian) as
    one ``.safetensors`` file. As the reference writer does, the header is
    padded with spaces to a multiple of 8 bytes and the tensors follow by
    element size, largest first, then by name, so that every tensor starts
    at a multiple of its element size. Returns the bytes written."""
    header, offset = {}, 0
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + offset
