"""Counter-based random numbers equal to ``jax.random``'s — the port's
counterpart of the calls the reference makes: ``PRNGKey``, ``split``,
``fold_in``, ``bits``, ``uniform``, ``normal``, ``truncated_normal`` and
``randint``.

Both packages draw from the Threefry-2x32 block cipher (20 rounds,
rotations (13, 15, 26, 6) and (17, 29, 16, 24), a key-schedule injection
every 4 rounds with ``ks2 = k1 ^ k2 ^ 0x1BD11BDA``).  The layout matched is
JAX's *partitionable* one (``jax_threefry_partitionable=True``, the default
since jax 0.5 and what the reference runs): every output element ``i`` of
a draw of shape ``s`` enciphers its own 64-bit counter ``i`` (row-major
over ``s``), split into the (hi, lo) words, so an element's bits depend on
its index only and not on how the array is laid out or sharded.  The older
layout enciphered one counter run split in two halves; its bits differ.

* A key is a ``np.ndarray`` of two ``uint32``.  Deriving keys (``PRNGKey``,
  ``split``, ``fold_in``) happens on the host in numpy, so it never waits
  for the card.
* ``bits``, ``uniform`` and ``normal`` build their counters on the tensor's
  device and run the cipher there in int64 tensor ops masked to 32 bits.
  This is plain PyTorch and no kernel: XLA computes it outside any Pallas
  kernel as well.
* Row keys: the per-link paths draw under one key per edge, the reference's
  ``vmap`` of ``fold_in`` / ``split`` / ``uniform`` over the edges.  Here a
  batch of keys is an int64 tensor ``[E, 2]`` on the device (the words
  held as uint32 values): ``fold_in(key, ids)`` with a host key and an
  ``[E]`` tensor of data makes one, ``fold_in(keys, data)`` and
  ``split(keys, n)`` (``[E, n, 2]``) derive from one, and ``bits``,
  ``uniform``, ``randint`` and ``normal`` under it draw a ``shape`` whose
  leading axis is the key axis (``E``): row e is the draw of ``shape[1:]``
  under key e.  Under ``vmap`` JAX enciphers each row's counters exactly
  as it does one key's, so row e is bit for bit the unbatched draw, and a
  function written for one key and an ``[E, ...]`` operand draws per row
  unchanged.  ``split(key)[..., i, :]`` picks the i-th subkey of either
  form.
* Host row keys: a ``np.ndarray`` ``[E, 2]`` of uint32 (the grids' per-cell
  keys, `repro_torch.sim.engine`).  ``split`` and ``fold_in`` derive from
  them on the host, vectorized over the rows (``[E, n, 2]`` and
  ``[E, 2]``), so deriving never waits for the card; a draw under them
  copies the ``E`` keys to the draw's device (pinned, without waiting)
  and draws as under ``[E, 2]`` row keys.

Key use: `RECORDER` is None unless `repro_torch.analysis.prng` records a
run; a draw then pays one ``is None`` test, and a recorder sees each
outermost public draw (``bits``, ``uniform``, ``normal``, ``randint``,
``truncated_normal``; the calls nested inside one are the same draw) with
its key and frame.

Equality with ``jax.random``: keys, splits, fold-ins, bits, uniforms and
32-bit randints are bit for bit (``tests/test_torch_prng.py``).  ``normal`` is
``sqrt(2) * erfinv(u)`` over ``u`` uniform in ``(-1, 1)``, as in JAX, with
``torch.erfinv`` in place of XLA's float32 ``ErfInv`` polynomial: one
launch, where emulating the polynomial's fused multiply-adds in eager
PyTorch takes some 180 and still leaves 1% of draws unequal (``log1p``).
On the CPU it equals ``jax.random.normal`` on 41% of draws and is within
a relative 5.8e-6 (absolute 2.2e-5) everywhere, measured over 24M draws.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# The key-use recorder (`repro_torch.analysis.prng.KeyRecord`); None when
# no check records.
RECORDER = None


def _draw(fn):
    """A public draw: straight through unless a recorder is on, which then
    sees the call (and runs it)."""

    @functools.wraps(fn)
    def draw(*args, **kwargs):
        if RECORDER is None:
            return fn(*args, **kwargs)
        return RECORDER.draw(fn, args, kwargs)

    return draw


def _threefry2x32(k1, k2, x0, x1, *, rotl, mask):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under key
    ``(k1, k2)``.  ``rotl`` and ``mask`` adapt it to numpy uint32 arrays
    (which wrap by themselves); `_t_cipher` is its int64 tensor form."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = mask(x0 + ks[0])
    x1 = mask(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = mask(x0 + x1)
            x1 = rotl(x1, r) ^ x0
        x0 = mask(x0 + ks[(i + 1) % 3])
        x1 = mask(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _np_rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _np_cipher(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(k1, k2, x0.astype(np.uint32), x1.astype(np.uint32),
                               rotl=_np_rotl, mask=lambda v: v.astype(np.uint32))
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (the reference's name)
    """``jax.random.PRNGKey(seed)`` as JAX computes it without 64-bit
    types (its default): the seed's low 32 bits, under a zero high word."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def _t_cipher(k1, k2, x0, x1):
    """Threefry-2x32 in int64 tensor ops; keys and counters broadcast.  The
    rounds run in place on two buffers and one scratch (the same integer
    ops as `_threefry2x32`, bit for bit): a large draw keeps three
    temporaries, not one a step."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = torch.broadcast_tensors((x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK)
    x0, x1 = x0.contiguous(), x1.contiguous()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            torch.bitwise_left_shift(x1, r, out=tmp).bitwise_and_(_MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


def is_rows(key) -> bool:
    """Whether ``key`` is a batch of row keys (an ``[E, 2]`` tensor)."""
    return isinstance(key, torch.Tensor)


def is_host_rows(key) -> bool:
    """Whether ``key`` is a batch of host row keys (a uint32 ``[E, 2]``
    array)."""
    return isinstance(key, np.ndarray) and key.ndim == 2


def _np_cipher_rows(keys: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """`_np_cipher` under each row key of ``keys [E, 2]``, the counters
    ``[n]`` broadcast: ``[E, n, 2]``."""
    k = np.asarray(keys, np.uint32)
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(k[:, 0:1], k[:, 1:2], x0.astype(np.uint32)[None],
                               x1.astype(np.uint32)[None], rotl=_np_rotl,
                               mask=lambda v: v.astype(np.uint32))
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def device_rows(keys: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """Host row keys ``[E, 2]`` as the ``[E, 2]`` int64 row keys of
    ``device``: a pinned copy that does not wait for the device's queue."""
    host = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))
    dev = torch.device(device)
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host.to(dev)


def _row_words(keys: torch.Tensor):
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"row keys are an int64 [E, 2] tensor, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    return keys[:, 0:1], keys[:, 1:2]


def split(key, n: int = 2):
    """``jax.random.split(key, n)``: ``[n, 2]`` keys, the cipher of the
    counters ``(0, i)``; under row keys ``[E, n, 2]``."""
    if is_rows(key):
        k1, k2 = _row_words(key)
        i = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
        b1, b2 = _t_cipher(k1, k2, i >> 32, i & _MASK)
        return torch.stack([b1, b2], dim=-1)
    i = np.arange(n, dtype=np.uint64)
    if is_host_rows(key):
        return _np_cipher_rows(key, (i >> np.uint64(32)).astype(np.uint32),
                               (i & np.uint64(_MASK)).astype(np.uint32))
    return _np_cipher(np.asarray(key), (i >> np.uint64(32)).astype(np.uint32),
                      (i & np.uint64(_MASK)).astype(np.uint32))


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the cipher of the counter
    ``(0, uint32(data))``.  A host key with an integer tensor ``data [E]``
    gives ``[E, 2]`` row keys (``vmap`` of ``fold_in`` over the data, on
    its device), and row keys fold ``data`` into each row.  Host row keys
    ``[C, 2]`` with a tensor ``data [n]`` give the ``[C n, 2]`` row keys of
    every key folded with every datum (the per-link keys of C cells)."""
    if is_rows(key):
        k1, k2 = _row_words(key)
        word = int(data) & _MASK
        b1, b2 = _t_cipher(k1[:, 0], k2[:, 0], torch.zeros_like(k1[:, 0]),
                           torch.full_like(k1[:, 0], word))
        return torch.stack([b1, b2], dim=-1)
    if is_host_rows(key) and isinstance(data, torch.Tensor):
        # each host row key folded with every datum: [E n, 2] row keys,
        # row e n + i = fold_in(key_e, data_i)
        k = device_rows(key, data.device)
        word = (data.reshape(-1).to(torch.int64) & _MASK)[None, :]
        b1, b2 = _t_cipher(k[:, 0:1], k[:, 1:2], torch.zeros_like(word), word)
        return torch.stack([b1, b2], dim=-1).reshape(-1, 2)
    if is_host_rows(key):
        word = np.array([int(data) & _MASK], dtype=np.uint32)
        return _np_cipher_rows(key, np.zeros(1, np.uint32), word)[:, 0]
    if isinstance(data, torch.Tensor):
        k1, k2 = _key_words(key)
        word = data.reshape(-1).to(torch.int64) & _MASK
        b1, b2 = _t_cipher(k1, k2, torch.zeros_like(word), word)
        return torch.stack([b1, b2], dim=-1)
    word = np.array([int(data) & _MASK], dtype=np.uint32)
    return _np_cipher(np.asarray(key), np.zeros(1, np.uint32), word)[0]


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {k.shape}")
    return int(k[0]), int(k[1])


@_draw
def bits(key, shape, device: str | torch.device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) on ``device``: an int64
    tensor holding the uint32 values, ``b1 ^ b2`` of each element's
    counter.  Under ``[E, 2]`` row keys ``shape[0]`` must be ``E``: row e
    is ``bits(key_e, shape[1:])``, on the keys' device."""
    shape = tuple(int(s) for s in shape)
    if is_host_rows(key):
        key = device_rows(key, device)
    if is_rows(key):
        k1, k2 = _row_words(key)
        if not shape or shape[0] != key.shape[0]:
            raise ValueError(f"a draw under {key.shape[0]} row keys needs a leading axis of "
                             f"{key.shape[0]}, got shape {shape}")
        n = int(np.prod(shape[1:]))
        idx = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
        b1, b2 = _t_cipher(k1, k2, idx >> 32, idx & _MASK)
        return (b1 ^ b2).reshape(shape)
    n = _count(shape)
    k1, k2 = _key_words(key)
    if n <= RANGE:
        return _cipher_range(k1, k2, 0, n, device).reshape(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for lo in range(0, n, RANGE):
        hi = min(lo + RANGE, n)
        out[lo:hi] = _cipher_range(k1, k2, lo, hi, device)
    return out.reshape(shape)


# Counters a host key's draw enciphers at once.  Threefry is counter-based:
# the draw over counters [a, b) is that slice of the whole draw, so a large
# draw runs range by range, its int64 temporaries a range's size (a full-width
# embedding's 389M counters would otherwise take several 3 GB temporaries,
# and its [4, ...] perturbation 12 GB each).
RANGE = 1 << 24


def _count(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _cipher_range(k1: int, k2: int, lo: int, hi: int, device) -> torch.Tensor:
    """The 32-bit draws of counters ``[lo, hi)`` under the host key
    ``(k1, k2)``, as int64."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    b1, b2 = _t_cipher(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def _unit(raw: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    """Raw 32-bit draws as uniforms in ``[lo, lo + span)``: the top 23 bits
    as a float in ``[1, 2)`` minus 1, scaled."""
    one = ((raw >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(one * span + lo, min=lo)


@_draw
def uniform(key, shape, device: str | torch.device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits of each draw as a float in ``[1, 2)`` minus 1, scaled to
    ``[minval, maxval)``.  A host key's draw of more than `RANGE` values
    runs range by range into the float32 result."""
    # the bounds as float32 values in Python scalars: a device tensor built
    # from a host scalar would wait for the card on every draw
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    shape = tuple(int(s) for s in shape)
    n = _count(shape)
    if is_rows(key) or is_host_rows(key) or n <= RANGE:
        return _unit(bits(key, shape, device), lo, span)
    k1, k2 = _key_words(key)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, RANGE):
        b = min(a + RANGE, n)
        out[a:b] = _unit(_cipher_range(k1, k2, a, b, device), lo, span)
    return out.reshape(shape)


def _mulmod32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``(a * m) mod 2**32`` for ``a`` and ``m`` below ``2**32``, in int64
    without overflow: ``a`` split into 16-bit halves."""
    hi = ((a >> 16) * m) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * m) & _MASK


@_draw
def randint(key, shape, minval: int, maxval: int, dtype: torch.dtype,
            device: str | torch.device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two 32-bit
    draws under ``split(key)``, ``hi`` and ``lo``, folded into
    ``[minval, maxval)`` in uint32 arithmetic as JAX does
    (``(hi % span) * multiplier + lo % span``, each step wrapping at
    ``2**32``, then ``% span``, with ``multiplier = (2**16 % span)**2 % span``,
    the square wrapping too);
    the wrap is emulated in int64.  Only 32-bit draws (``dtype`` int32):
    JAX draws as many bits as the dtype has, and the reference asks for
    int32."""
    if dtype != torch.int32:
        raise TypeError(f"randint draws 32-bit integers (torch.int32), got {dtype}")
    minval, maxval = int(minval), int(maxval)
    if not -(2 ** 31) <= min(minval, maxval) <= max(minval, maxval) < 2 ** 31:
        raise ValueError(f"randint bounds must be int32 values, got [{minval}, {maxval})")
    span = (maxval - minval) & _MASK if maxval > minval else 1
    keys = split(key)
    hi, lo = bits(keys[..., 0, :], shape, device), bits(keys[..., 1, :], shape, device)
    mult = 2 ** 16 % span
    mult = ((mult * mult) & _MASK) % span
    offset = ((_mulmod32(hi % span, mult) + lo % span) & _MASK) % span
    # minval + offset in int32 arithmetic (wrapping, as the reference's add)
    val = (offset + minval) & _MASK
    return torch.where(val >= 2 ** 31, val - 2 ** 32, val).to(torch.int32)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


@_draw
def normal(key, shape, device: str | torch.device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``:
    ``sqrt(2) * erfinv(u)`` with ``u`` uniform in ``(-1, 1)`` (see the
    module docstring for the tolerance)."""
    u = uniform(key, shape, device, _NORMAL_LO, 1.0)
    return u.erfinv_().mul_(_SQRT2)  # in place: a full-width draw keeps one buffer


def _erf_f32(x: np.float32) -> np.float32:
    return np.float32(torch.erf(torch.tensor(x, dtype=torch.float32)).item())


@_draw
def truncated_normal(key, lower: float, upper: float, shape,
                     device: str | torch.device) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    ``sqrt(2) * erfinv(u)`` with ``u`` uniform in ``[erf(lower / sqrt(2)),
    erf(upper / sqrt(2)))``, clamped into the open interval ``(lower,
    upper)``; within `normal`'s tolerance of the reference (``torch.erfinv``
    and ``torch.erf`` in place of XLA's polynomials)."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    u = uniform(key, shape, device, _erf_f32(lo / sqrt2), _erf_f32(hi / sqrt2))
    out = u.erfinv_().mul_(float(sqrt2))
    return out.clamp_(float(np.nextafter(lo, np.float32(np.inf))),
                      float(np.nextafter(hi, np.float32(-np.inf))))
