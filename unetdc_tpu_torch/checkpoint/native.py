"""Native msgpack checkpoints, file-compatible with the JAX package's
`checkpoint/native.py` (flax `msgpack_serialize` / `msgpack_restore`).

The codec here is the port's own, so neither flax nor the `msgpack`
package is needed. It reads and writes what flax writes:

- maps with str keys, nil, bool, ints, floats, str, bin and arrays (lists);
- numpy arrays as ext type 1, whose payload is the msgpack encoding of
  `(shape, dtype.name, bytes in C order)`;
- numpy scalars as ext type 3 (the same payload, shape ());
- arrays larger than flax's chunk limit (2**30 bytes) as a chunked map
  `{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
  {"0": flat array, ..}}`.

Anything else (complex numbers, bfloat16 arrays, other ext types, object
dtypes, non-str keys) raises: the codec never guesses.

Files: `path` (msgpack), `path.meta.json` (metadata), each written to
`path.tmp` first and moved into place with `os.replace`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30          # flax serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------- encoding --
def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(bytes([v & 0xFF]))
    elif 0 <= v <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif 0 <= v <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x80 <= v < 0:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif -0x8000 <= v < 0:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif -0x80000000 <= v < 0:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif -0x8000000000000000 <= v < 0:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise ValueError(f"msgpack: integer {v} out of range")


def _pack_len(n: int, out: list, fix: Optional[int], fix_max: int,
              codes) -> None:
    """Length header: a fix form (type code | n) when n <= fix_max, else the
    8/16/32-bit forms in `codes` (None where the form does not exist)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n <= 0xFF:
        out.append(bytes([codes[0]]) + struct.pack(">B", n))
    elif n <= 0xFFFF:
        out.append(bytes([codes[1]]) + struct.pack(">H", n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes([codes[2]]) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack: object of length {n} too large")


def _pack_ext(code: int, payload: list, out: list) -> None:
    n = sum(len(p) for p in payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(bytes([fixext[n]]))
    elif n <= 0xFF:
        out.append(b"\xc7" + struct.pack(">B", n))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc9" + struct.pack(">I", n))
    else:
        raise ValueError("msgpack: ext payload too large")
    out.append(struct.pack(">b", code))
    out += payload


def _ndarray_payload(arr: np.ndarray) -> list:
    """flax `_ndarray_to_bytes`: packb((shape, dtype.name, C bytes)), as
    pieces (the array's bytes are not copied again)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct \
            or arr.dtype.names is not None or arr.dtype.kind in "cUSV":
        raise ValueError(f"msgpack: unsupported array dtype {arr.dtype}")
    out = [b"\x93"]
    _pack(tuple(int(s) for s in arr.shape), out, top=False)
    _pack(arr.dtype.name, out, top=False)
    data = memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")
    _pack_len(len(data), out, None, -1, (0xC4, 0xC5, 0xC6))
    out.append(data)
    return out


def _pack(obj: Any, out: list, top: bool = True) -> None:
    # exact type checks, as flax packs with strict_types=True: numpy scalars
    # (np.float64 is a float subclass) become ext 3, not native floats
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif t in (bytes, bytearray, memoryview):
        b = bytes(obj)
        _pack_len(len(b), out, None, -1, (0xC4, 0xC5, 0xC6))
        out.append(b)
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if type(k) is not str:
                raise ValueError(f"msgpack: non-str key {k!r}")
            _pack(k, out, top)
            _pack(v, out, top)
    elif t is list or (t is tuple and not top):
        # a tuple appears only inside an ndarray payload (its shape)
        _pack_len(len(obj), out, 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out, top)
    elif t is np.ndarray:
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic) and not isinstance(obj, np.object_):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise ValueError(f"msgpack: cannot serialize {t.__name__}")


def _chunk_leaves(d):
    """flax's copy of the tree (`jax.tree_util.tree_map`, which orders every
    map's keys) followed by `_chunk_array_leaves_in_place`: arrays held in
    maps and larger than MAX_CHUNK_SIZE bytes become chunked maps, whose
    own keys keep flax's insertion order."""
    if not isinstance(d, dict):
        return d
    if any(type(k) is not str for k in d):
        raise ValueError(f"msgpack: non-str key in {list(d)!r}")
    out = {}
    for k in sorted(d):
        v = d[k]
        if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_SIZE:
            n = max(1, int(MAX_CHUNK_SIZE / v.dtype.itemsize))
            flat = v.reshape(-1)
            out[k] = {_CHUNKED: True,
                      "shape": {str(i): int(s) for i, s in enumerate(v.shape)},
                      "chunks": {str(j): flat[i:i + n] for j, i in
                                 enumerate(range(0, flat.size, n))}}
        else:
            out[k] = _chunk_leaves(v)
    return out


def _pack_pieces(tree: Any) -> list:
    out: list = []
    _pack(_chunk_leaves(tree), out)
    return out


def packb(tree: Any) -> bytes:
    """Encode a tree of dicts and numpy leaves as flax's msgpack_serialize
    does (torch tensors must be converted to numpy first)."""
    return b"".join(_pack_pieces(tree))


# ------------------------------------------------------------- decoding --
class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.b):
            raise ValueError("msgpack: truncated data")
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    def u(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = _unpack(_Reader(data), raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    dt = np.dtype(name)
    return np.frombuffer(bytes(buf), dtype=dt).reshape(shape, order="C")


def _unpack(r: _Reader, raw: bool = False) -> Any:
    c = r.u(">B")
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _unpack_map(r, c & 0x0F, raw)
    if 0x90 <= c <= 0x9F:
        return [_unpack(r, raw) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return _str(r.take(c & 0x1F), raw)
    fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
             0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
    if c in fixed:
        v = r.u(fixed[c])
        return float(v) if c in (0xCA, 0xCB) else v
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
             0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if c in sizes:
        n = r.u(sizes[c])
        if c in (0xD9, 0xDA, 0xDB):
            return _str(r.take(n), raw)
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if c in (0xDC, 0xDD):
            return [_unpack(r, raw) for _ in range(n)]
        return _unpack_map(r, n, raw)
    ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if c in ext:
        n = ext[c]
    elif c in (0xC7, 0xC8, 0xC9):
        n = r.u({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{c:02x}")
    code = r.u(">b")
    data = bytes(r.take(n))
    if code == _EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"msgpack: unsupported ext type {code}")


def _str(b: memoryview, raw: bool):
    return bytes(b) if raw else bytes(b).decode("utf-8")


def _unpack_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        if isinstance(k, (dict, list)):
            raise ValueError("msgpack: unhashable map key")
        out[k] = _unpack(r, raw)
    return out


def _unchunk(d):
    """flax `_unchunk_array_leaves_in_place`."""
    if not isinstance(d, dict):
        return d
    if _CHUNKED in d:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in d.items()}


def unpackb(data: bytes) -> Any:
    """Decode what flax's msgpack_serialize (or `packb`) wrote."""
    r = _Reader(data)
    tree = _unpack(r)
    if r.i != len(r.b):
        raise ValueError("msgpack: trailing bytes after the object")
    return _unchunk(tree)


# ---------------------------------------------------------------- files --
def _to_numpy_tree(tree):
    """Every leaf as a numpy array, as the JAX package's save_checkpoint
    does (`tree_map(np.asarray)`): torch tensors copied to the host, numpy
    and Python scalars become 0-d arrays; None stays None."""
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if tree is None:
        return None
    if hasattr(tree, "detach") and hasattr(tree, "numpy"):
        return tree.detach().cpu().contiguous().numpy()
    return np.asarray(tree)


def _write_atomic(path: str, pieces: list) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(pieces)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree: Any, metadata: Optional[dict] = None):
    """Serialize a tree (variables / full train state) to `path` (msgpack)
    and, when given, `metadata` to `path.meta.json`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_atomic(path, _pack_pieces(_to_numpy_tree(tree)))
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_metadata(path: str) -> Optional[dict]:
    meta = path + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return None


class BestMetricCheckpointer:
    """Save-on-new-best with early-stop patience, as the reference training
    loops do (best val dice, patience 5 — train_DC_focal.py:229-231)."""

    def __init__(self, path: str, patience: int = 5, mode: str = "max"):
        self.path = path
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0

    def is_improvement(self, value: float) -> bool:
        if self.best is None:
            return True
        return value > self.best if self.mode == "max" else value < self.best

    def update(self, value: float, tree: Any, metadata: Optional[dict] = None
               ) -> bool:
        """Returns True if training should stop (patience exhausted)."""
        if self.is_improvement(value):
            self.best = value
            self.counter = 0
            md = dict(metadata or {})
            md["best_metric"] = float(value)
            save_checkpoint(self.path, tree, md)
            return False
        self.counter += 1
        return self.counter >= self.patience
