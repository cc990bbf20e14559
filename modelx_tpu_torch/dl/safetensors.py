"""safetensors format: header parsing, whole-tensor reads, and writing.

The port's own copy of ``modelx_tpu/dl/safetensors.py``, with the same byte
format: an 8-byte little-endian header length, a JSON header mapping each
tensor name to {dtype, shape, data_offsets: [start, end]} (offsets relative
to the end of the header, padded to 8 bytes), then raw little-endian tensor
bytes. Tensors come back as torch tensors, so BF16 and F8 need no
``ml_dtypes``: their bytes are viewed as torch's own types.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
# numpy dtype names -> tag, for arrays handed over from numpy; "bfloat16",
# "float8_e4m3fn" and "float8_e5m2" are ml_dtypes' names, recognised by
# name so this module never imports ml_dtypes
_NP_NAMES = {
    "float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
    "float8_e4m3fn": "F8_E4M3", "float8_e5m2": "F8_E5M2", "int64": "I64",
    "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL",
}


@dataclasses.dataclass
class TensorInfo:
    name: str
    dtype: str  # safetensors dtype tag, e.g. "BF16"
    shape: tuple[int, ...]
    start: int  # byte offsets relative to data section start
    end: int
    # a stacked tensor folded from per-expert entries (``dl/loader.py
    # fuse_expert_tensors``): its bytes are these members', in order, and
    # start/end are the first member's start and start + the total
    members: "list[TensorInfo] | None" = None

    @property
    def nbytes(self) -> int:
        return self.end - self.start

    def torch_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(
                f"unsupported safetensors dtype {self.dtype!r} for {self.name}"
            ) from None


def parse_header(header_bytes: bytes) -> dict[str, TensorInfo]:
    d = json.loads(header_bytes)
    out: dict[str, TensorInfo] = {}
    for name, info in d.items():
        if name == "__metadata__":
            continue
        out[name] = TensorInfo(
            name=name,
            dtype=info["dtype"],
            shape=tuple(info["shape"]),
            start=info["data_offsets"][0],
            end=info["data_offsets"][1],
        )
    return out


def read_header(reader: BinaryIO) -> tuple[dict[str, TensorInfo], int]:
    """Returns (tensors, data_offset): data_offset is the absolute file
    offset where tensor data begins."""
    prefix = reader.read(8)
    if len(prefix) != 8:
        raise ValueError("truncated safetensors file")
    (header_len,) = struct.unpack("<Q", prefix)
    if header_len > 512 * 1024 * 1024:
        raise ValueError(f"implausible safetensors header length {header_len}")
    header = reader.read(header_len)
    return parse_header(header), 8 + header_len


def read_header_from_file(path: str) -> tuple[dict[str, TensorInfo], int]:
    with open(path, "rb") as f:
        return read_header(f)


def bytes_to_tensor(raw, info: TensorInfo) -> torch.Tensor:
    """A CPU tensor of ``info``'s dtype and shape over the bytes ``raw``
    (a uint8 tensor or anything numpy can view), without copying."""
    if not isinstance(raw, torch.Tensor):
        raw = torch.from_numpy(np.frombuffer(raw, np.uint8))
    if raw.numel() != info.nbytes:
        raise ValueError(f"{info.name}: {raw.numel()} bytes, header says {info.nbytes}")
    return raw.view(info.torch_dtype()).reshape(info.shape)


def read_tensors(path: str, want=None) -> dict[str, torch.Tensor]:
    """Read whole tensors from one file; ``want(name)`` filters without
    touching skipped tensors' bytes. Tensors own their memory."""
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        infos, off = read_header(f)
        for name, info in infos.items():
            if want is not None and not want(name):
                continue
            f.seek(off + info.start)
            buf = bytearray(info.nbytes)
            if f.readinto(buf) != info.nbytes:
                raise ValueError(f"truncated safetensors file at {name}")
            out[name] = bytes_to_tensor(buf, info)
    return out


def _tag_and_bytes(name: str, arr) -> tuple[str, tuple[int, ...], int, Any]:
    """(tag, shape, nbytes, bytes-producer) of one torch tensor or numpy array."""
    if isinstance(arr, torch.Tensor):
        tag = _DTYPE_NAMES.get(arr.dtype)
        if tag is None:
            raise ValueError(f"unsupported torch dtype {arr.dtype} for {name}")

        def payload(t=arr):
            flat = t.detach().contiguous().reshape(-1).cpu()
            return flat.view(torch.uint8).numpy()

        return tag, tuple(arr.shape), arr.numel() * arr.element_size(), payload
    arr = np.ascontiguousarray(arr)
    tag = _NP_NAMES.get(arr.dtype.name)
    if tag is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype} for {name}")
    return tag, tuple(arr.shape), arr.nbytes, (lambda a=arr: a.reshape(-1).view(np.uint8))


def write_safetensors(path: str, tensors: dict, metadata: dict[str, str] | None = None) -> None:
    """Write a safetensors file from torch tensors (any device) or numpy
    arrays. Tensors are copied to the host one at a time, so writing a
    checkpoint that lives on the card needs one tensor of host memory."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    payloads = []
    for name, arr in tensors.items():
        tag, shape, n, payload = _tag_and_bytes(name, arr)
        header[name] = {"dtype": tag, "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        payloads.append(payload)
        offset += n
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((8 - len(hjson) % 8) % 8)  # 8-byte alignment (spec)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for payload in payloads:
            f.write(memoryview(payload()))


def tensor_index_annotation(tensors: dict[str, TensorInfo], data_offset: int) -> str:
    """The header as the ``modelx.tensor.index`` blob annotation (the JAX
    package's bytes for the same header)."""
    index = {
        name: {"dtype": t.dtype, "shape": list(t.shape), "data_offsets": [t.start, t.end]}
        for name, t in tensors.items()
    }
    return json.dumps({"data_offset": data_offset, "tensors": index}, sort_keys=True)


def parse_index_annotation(payload: str) -> tuple[dict[str, TensorInfo], int]:
    d = json.loads(payload)
    tensors = {}
    for name, info in d["tensors"].items():
        tensors[name] = TensorInfo(
            name=name,
            dtype=info["dtype"],
            shape=tuple(info["shape"]),
            start=info["data_offsets"][0],
            end=info["data_offsets"][1],
        )
    return tensors, int(d["data_offset"])
