"""A safetensors reader and writer of the port's own (numpy and torch only;
the ``safetensors`` package is not a dependency of the port).

The format: an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, offsets relative to the first byte after the header), then
the raw little-endian tensor bytes, back to back. The writer pads the header
with spaces to a multiple of 8 bytes, as the ``safetensors`` package does, so
files written here open with ``safetensors.safe_open`` and files it writes
open here.

``SafetensorsFile.get`` reads one tensor at a time (``numpy.fromfile`` at
its offset): host memory holds one tensor, never the file. BF16 is read as
``uint16`` and viewed as ``torch.bfloat16``. ``save_file`` writes one tensor
at a time too, copying a device tensor to the host only while it is written.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

# safetensors dtype tag -> (numpy storage dtype, torch dtype)
_DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "F64": (np.dtype("<f8"), torch.float64),
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}
_TAG_OF_TORCH = {t: tag for tag, (_, t) in _DTYPES.items()}
_TAG_OF_NUMPY = {np.dtype(n).newbyteorder("<") if n.itemsize > 1 else n: tag
                 for tag, (n, _) in _DTYPES.items() if tag != "BF16"}

Array = Union[np.ndarray, torch.Tensor]


class SafetensorsFile:
    """One ``.safetensors`` file's header, with tensors read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.data_start = 8 + n
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self.entries: Dict[str, dict] = header
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {e['dtype']}")

    def keys(self) -> Iterable[str]:
        return self.entries.keys()

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.entries[name]["shape"])

    def get(self, name: str) -> torch.Tensor:
        """The tensor as a CPU ``torch.Tensor`` of its stored dtype."""
        e = self.entries[name]
        np_dtype, t_dtype = _DTYPES[e["dtype"]]
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize:
            raise ValueError(f"{self.path}: tensor {name} spans {end - begin} bytes, "
                             f"its shape and dtype need {count * np_dtype.itemsize}")
        with open(self.path, "rb") as f:
            f.seek(self.data_start + begin)
            arr = np.fromfile(f, dtype=np_dtype, count=count)
        if arr.size != count:
            raise ValueError(f"{self.path}: tensor {name} is truncated")
        t = torch.from_numpy(arr.reshape(shape))
        return t.view(t_dtype) if e["dtype"] == "BF16" else t


def _tag(value: Array) -> str:
    if isinstance(value, torch.Tensor):
        if value.dtype not in _TAG_OF_TORCH:
            raise ValueError(f"unsupported torch dtype {value.dtype}")
        return _TAG_OF_TORCH[value.dtype]
    dt = np.dtype(value.dtype)
    if dt.name == "bfloat16":  # an ml_dtypes array handed in by a caller
        return "BF16"
    key = dt.newbyteorder("<") if dt.itemsize > 1 else dt
    if key not in _TAG_OF_NUMPY:
        raise ValueError(f"unsupported numpy dtype {dt}")
    return _TAG_OF_NUMPY[key]


def _host_bytes(value: Array) -> memoryview:
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(value)
        if arr.dtype.itemsize > 1 and arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
    return memoryview(arr.reshape(-1).view(np.uint8))


def save_file(tensors: Mapping[str, Array], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors, on any device) to
    ``path`` (through a temporary file and a rename)."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, value in tensors.items():
        nbytes = int(np.prod(tuple(value.shape), dtype=np.int64)) * (
            value.element_size() if isinstance(value, torch.Tensor) else np.dtype(value.dtype).itemsize
        )
        header[name] = {"dtype": _tag(value), "shape": list(value.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for value in tensors.values():
                f.write(_host_bytes(value))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class LazyStateDict:
    """Mapping over safetensors shards that reads one tensor at a time
    (JAX ``models/loader.py`` ``_LazyStateDict``): the host holds one tensor,
    not the checkpoint."""

    def __init__(self, files: Iterable[str]):
        self._files: Dict[str, SafetensorsFile] = {}
        self._index: Dict[str, str] = {}
        for path in files:
            st = SafetensorsFile(path)
            self._files[path] = st
            for name in st.keys():
                self._index[name] = path

    def keys(self):
        return self._index.keys()

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._files[self._index[name]].get(name)
