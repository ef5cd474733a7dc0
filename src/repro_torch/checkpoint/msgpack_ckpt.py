"""Checkpoints in the reference's file layout — port of
`repro.checkpoint.msgpack_ckpt`, with its own reader and writer of the
msgpack subset the layout uses (the card's machine has no ``msgpack``).

Layout, as the reference's: ``<dir>/step_<N:08d>.msgpack`` holding one map
``{"treedef": str, "num_leaves": int, "leaves": [{"dtype": str, "shape":
[int, ...], "data": bin}, ...]}``, published atomically (written to a
``.tmp`` file, then renamed).  The encoder writes the bytes
``msgpack.packb(payload, use_bin_type=True)`` writes (the smallest integer,
string, binary, array and map forms), streaming each leaf's bytes to the
file; the decoder reads maps, arrays, str, bin, int, nil and bool.

Leaves are in the reference's pytree order: a dict's by sorted key (the
port's flat keys sort as the reference's nested tree, `repro_torch.convert`),
tuples and NamedTuples by position, None holding none, and a
`repro_torch.core.bridge.BridgeState` in the reference's field order
(``params, t, key, net, comm, adv, obs, trust, mets``: the port keeps
``comm`` before ``net``).  A tick is written as the reference's int32 0-d
array and a key as its uint32 ``[2]``, so a plain-path state (identity
codec, no network, trace, trust or metrics carry) crosses between the
packages both ways.  The reference's ``restore`` checks the leaf count and
shapes, never ``treedef``; the port writes its own structure string there
(`structure`) and checks it when it restores a file it wrote.
"""
from __future__ import annotations

import os
import re
import struct
from typing import Any

import numpy as np
import torch

PORT_TAG = "repro_torch:"
# the reference's BridgeState field order (the port's differs: comm, net)
_BRIDGE_ORDER = ("params", "t", "key", "net", "comm", "adv", "obs", "trust", "mets")


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _head(f, fix: int, fix_max: int, codes: tuple, n: int) -> None:
    """A length header: the fix form up to ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (None where the family has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        f.write(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        f.write(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        f.write(struct.pack(">BH", codes[1], n))
    else:
        f.write(struct.pack(">BI", codes[2], n))


def _pack_int(f, n: int) -> None:
    if 0 <= n < 0x80:
        f.write(bytes([n]))
    elif -32 <= n < 0:
        f.write(struct.pack(">b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if n < top:
                f.write(struct.pack(fmt, code, n))
                return
        raise OverflowError(n)
    else:
        for code, fmt, lo in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                              (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if n >= lo:
                f.write(struct.pack(fmt, code, n))
                return
        raise OverflowError(n)


def pack(obj, f) -> None:
    """Write ``obj`` (dict, list/tuple, str, bytes/memoryview, int, bool,
    None) to the binary file ``f`` as msgpack."""
    if obj is None:
        f.write(b"\xc0")
    elif obj is True or obj is False:
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(f, obj)
    elif isinstance(obj, str):
        raw = obj.encode()
        _head(f, 0xA0, 31, (0xD9, 0xDA, 0xDB), len(raw))
        f.write(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        _head(f, None, -1, (0xC4, 0xC5, 0xC6), raw.nbytes)
        f.write(raw)
    elif isinstance(obj, (list, tuple)):
        _head(f, 0x90, 15, (None, 0xDC, 0xDD), len(obj))
        for x in obj:
            pack(x, f)
    elif isinstance(obj, dict):
        _head(f, 0x80, 15, (None, 0xDE, 0xDF), len(obj))
        for k, v in obj.items():
            pack(k, f)
            pack(v, f)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.at = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.at:self.at + n]
        if out.nbytes != n:
            raise ValueError("truncated msgpack data")
        self.at += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        code = self.take(1)[0]
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.read() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in fixed:
            return fixed[code]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                0xD2: ">i", 0xD3: ">q"}
        if code in ints:
            return self.num(ints[code])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if code not in sizes:
            raise ValueError(f"msgpack subset: unsupported type byte 0x{code:02x}")
        n = self.num(sizes[code])
        if code <= 0xC6:
            return self.take(n)  # bin: a view into the file's bytes
        if code <= 0xDB:
            return str(self.take(n), "utf-8")
        if code <= 0xDD:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpack(buf: bytes):
    """The object the msgpack bytes ``buf`` hold (str as str, bin as a
    ``memoryview`` into ``buf``)."""
    r = _Reader(buf)
    out = r.read()
    if r.at != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# pytrees of the port
# ---------------------------------------------------------------------------


def _is_bridge_state(x) -> bool:
    return hasattr(x, "_fields") and type(x).__name__ == "BridgeState"


def _children(x):
    """``(tag, children)`` of an inner node, or None for a leaf."""
    if x is None:
        return "None", []
    if isinstance(x, dict):
        keys = sorted(x)
        return "dict[" + ",".join(keys) + "]", [x[k] for k in keys]
    if _is_bridge_state(x):
        return "BridgeState", [getattr(x, f) for f in _BRIDGE_ORDER]
    if hasattr(x, "_fields"):
        return f"{type(x).__name__}", list(x)
    if isinstance(x, (tuple, list)):
        return f"{type(x).__name__}{len(x)}", list(x)
    return None


def flatten(tree) -> tuple[list, str]:
    """The leaves of a port pytree in the reference's order, and its
    structure string."""
    leaves: list = []

    def walk(x) -> str:
        node = _children(x)
        if node is None:
            leaves.append(x)
            return "*"
        tag, kids = node
        return tag + "(" + ",".join(walk(k) for k in kids) + ")" if kids else tag

    return leaves, walk(tree)


def structure(tree) -> str:
    """The structure string the port writes as ``treedef``."""
    return PORT_TAG + flatten(tree)[1]


def unflatten(template, leaves: list):
    """``template``'s structure with ``leaves`` (in `flatten`'s order)."""
    it = iter(leaves)

    def build(x):
        node = _children(x)
        if node is None:
            return next(it)
        if x is None:
            return None
        kids = [build(k) for k in node[1]]
        if isinstance(x, dict):
            return dict(zip(sorted(x), kids, strict=True))
        if _is_bridge_state(x):
            return type(x)(**dict(zip(_BRIDGE_ORDER, kids, strict=True)))
        if hasattr(x, "_fields"):
            return type(x)(*kids)
        return type(x)(kids)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _leaf_record(x) -> dict:
    """``{dtype, shape, data}`` of a tensor, an array or a Python int (a
    tick: the reference's int32 0-d array)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": memoryview(t.view(torch.int16).numpy()).cast("B")}
        x = t.numpy()
    elif isinstance(x, int):
        x = np.asarray(x, np.int32)
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:
        arr = arr.copy()  # np.ascontiguousarray would make a 0-d array 1-d
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": memoryview(arr.reshape(-1)).cast("B") if arr.size else b""}


def _leaf_value(rec: dict, tmpl):
    """A stored leaf in the template leaf's type (tensor on its device and
    in its dtype, numpy array, or Python int)."""
    dtype, shape = rec["dtype"], tuple(rec["shape"])
    want = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
    if shape != want:
        raise ValueError(f"shape mismatch: ckpt {shape} vs template {want}")
    if dtype == "bfloat16":
        t = torch.frombuffer(bytearray(rec["data"]), dtype=torch.int16).view(torch.bfloat16)
        arr = t.reshape(shape)
    else:
        arr = np.frombuffer(rec["data"], dtype=np.dtype(dtype)).reshape(shape)
    if isinstance(tmpl, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr.copy())
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.to(torch.float32).numpy()
    if isinstance(tmpl, np.ndarray):
        return arr.astype(tmpl.dtype)
    return type(tmpl)(arr.item())


# ---------------------------------------------------------------------------
# the reference's API
# ---------------------------------------------------------------------------


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.msgpack")


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` (a port pytree: the trainers' `BridgeState`, a
    parameter dict, a tuple) as ``step_<step>.msgpack``, streamed leaf by
    leaf to a ``.tmp`` file and renamed into place; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, shape = flatten(tree)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _head(f, 0x80, 15, (None, 0xDE, 0xDF), 3)
        pack("treedef", f)
        pack(PORT_TAG + shape, f)
        pack("num_leaves", f)
        pack(len(leaves), f)
        pack("leaves", f)
        _head(f, 0x90, 15, (None, 0xDC, 0xDD), len(leaves))
        for leaf in leaves:
            pack(_leaf_record(leaf), f)
    os.replace(tmp, path)  # atomic publish
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.msgpack", f))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, step: int | None = None) -> tuple[Any, int]:
    """``(tree, step)``: the checkpoint ``step`` (default the newest) in
    ``template``'s structure, each leaf in its template leaf's type.  A file
    the reference wrote is checked as the reference checks it (leaf count
    and shapes); a file the port wrote also against the template's
    structure string."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(_path(ckpt_dir, step), "rb") as f:
        payload = unpack(f.read())
    leaves, shape = flatten(template)
    stored = payload["leaves"]
    if len(stored) != len(leaves):
        raise ValueError(f"checkpoint has {len(stored)} leaves, template has {len(leaves)}")
    written = payload["treedef"]
    if written.startswith(PORT_TAG) and written != PORT_TAG + shape:
        raise ValueError(f"checkpoint structure {written!r} does not match the template's "
                         f"{PORT_TAG + shape!r}")
    values = [_leaf_value(d, t) for t, d in zip(leaves, stored, strict=True)]
    return unflatten(template, values), step
