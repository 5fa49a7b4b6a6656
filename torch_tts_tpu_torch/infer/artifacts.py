"""TTSB tensor files (port of `torch_tts_tpu/infer/artifacts.py`'s
`write_ttsb` / `read_ttsb`, numpy only).

The JAX package's C++ runtime reads parameters and data as tensor lists
in this format; the port writes and reads the same bytes:

  magic 'TTSB', u32 n_tensors, then per tensor:
  u32 dtype (0=f32, 1=i32), u32 rank, u64 dims[rank], raw data (little-endian, as
  the machines that write and read it).

`export_flat_fn` (StableHLO for the PJRT runtime) has no counterpart here:
a C++ runtime of the port would take a `torch.export` program instead.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}
_DTYPES_INV = {0: np.float32, 1: np.int32}


def write_ttsb(path: str, tensors: Sequence[np.ndarray]) -> None:
    """Write float32 / int32 arrays to `path` in the TTSB format."""
    with open(path, "wb") as f:
        f.write(b"TTSB")
        f.write(struct.pack("<I", len(tensors)))
        for t in tensors:
            t = np.ascontiguousarray(t)
            f.write(struct.pack("<II", _DTYPES[t.dtype], t.ndim))
            for d in t.shape:
                f.write(struct.pack("<Q", d))
            f.write(t.tobytes())


def read_ttsb(path: str) -> List[np.ndarray]:
    """The arrays of a TTSB file, in order."""
    out = []
    with open(path, "rb") as f:
        if f.read(4) != b"TTSB":
            raise ValueError(f"{path}: not a TTSB file")
        (n,) = struct.unpack("<I", f.read(4))
        for _ in range(n):
            code, rank = struct.unpack("<II", f.read(8))
            dims = [struct.unpack("<Q", f.read(8))[0] for _ in range(rank)]
            dt = np.dtype(_DTYPES_INV[code])
            count = int(np.prod(dims)) if dims else 1
            out.append(np.frombuffer(f.read(count * dt.itemsize), dt).reshape(dims))
    return out
