"""A frozen copy of the synthetic library's row generator.

A synthetic ``.tfsim`` library (``meta.json`` ``"fingerprints": {"kind":
"synthetic", "seed": S}``) has no rows on disk: row ``i`` is a pure function
of ``i`` and ``S`` through the ``lowbias32`` counter mixer. The server under
test generates them on the card; the reference regenerates them here, from
this copy, so that nothing it computes comes from the program. The test
``tests/test_harness_reference.py`` pins this copy to fixed row values, so a
change to the program's generator shows as a wrong answer, not as a moved
yardstick.

Row ``i`` (cluster ``c = i >> 8``) has 32-bit words ``w = 0 .. W-1``. With
``G = 0x9E3779B9``, ``s_row = S*G + 0x85EBCA6B`` and ``s_clu = S*G +
0xC2B2AE35`` (mod 2**32), the per-row base is ``hr = mix(i ^ s_row)`` and the
per-cluster base ``hc = mix(c ^ s_clu)``; each word takes two draws of each,
``a = mix(h + 2w*G)`` and ``b = mix(h + (2w+1)*G)``, and combines them::

    core  = ca & ror(ca,7) & ror(ca,15) & cb & ror(cb,11)
    keep  = ra | ror(ra,13)
    indiv = rb & ror(rb,3) & ror(rb,6) & ror(rb,12) & ror(rb,17) & ror(rb,24)
    word  = (core & keep) | indiv

Rows of one cluster share a sparse core, so every row has graded
neighbours; about 40 of 1024 bits are set.

Two forms: numpy ``uint32`` for the few rows the host checks, and PyTorch
``int32`` (same bits) for the full pass on the card. PyTorch has no unsigned
32-bit arithmetic: addition, multiplication and left shifts wrap modulo
2**32 alike on the int32 view, and the logical right shift masks off the
sign-filled bits.
"""

from __future__ import annotations

import numpy as np
import torch

GOLD = 0x9E3779B9
CLUSTER_ROWS = 256
M32 = 0xFFFFFFFF


def seed_consts(seed: int) -> tuple[int, int]:
    """``(s_row, s_clu)`` as Python ints in ``[0, 2**32)``."""
    return (seed * GOLD + 0x85EBCA6B) & M32, (seed * GOLD + 0xC2B2AE35) & M32


# ------------------------------------------------------------------ numpy


def _mix_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def _ror_np(x: np.ndarray, r: int) -> np.ndarray:
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def rows_np(idx, words: int, seed: int) -> np.ndarray:
    """Rows ``idx`` (any int array) as ``uint32 (K, words)``."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1).astype(np.uint32)
    s_row, s_clu = (np.uint32(v) for v in seed_consts(seed))
    offs = np.arange(2 * words, dtype=np.uint32) * np.uint32(GOLD)
    hr = _mix_np(idx ^ s_row)[:, None]
    hc = _mix_np((idx >> np.uint32(8)) ^ s_clu)[:, None]
    dr = _mix_np(hr + offs[None, :]).reshape(len(idx), words, 2)
    dc = _mix_np(hc + offs[None, :]).reshape(len(idx), words, 2)
    ca, cb, ra, rb = dc[..., 0], dc[..., 1], dr[..., 0], dr[..., 1]
    core = ca & _ror_np(ca, 7) & _ror_np(ca, 15) & cb & _ror_np(cb, 11)
    keep = ra | _ror_np(ra, 13)
    indiv = (rb & _ror_np(rb, 3) & _ror_np(rb, 6) & _ror_np(rb, 12)
             & _ror_np(rb, 17) & _ror_np(rb, 24))
    return (core & keep) | indiv


def fold_np(rows: np.ndarray, fold: int) -> np.ndarray:
    """OR-fold packed rows ``(..., W)`` to ``W // fold`` words: word ``w`` of
    the folded row is the OR of words ``g * (W // fold) + w``."""
    if fold == 1:
        return rows
    w = rows.shape[-1]
    return np.bitwise_or.reduce(rows.reshape(*rows.shape[:-1], fold, w // fold), axis=-2)


def popcount_np(rows: np.ndarray) -> np.ndarray:
    """Set bits of each packed row, int64."""
    return np.unpackbits(np.ascontiguousarray(rows).view(np.uint8), axis=-1).sum(
        axis=-1, dtype=np.int64)


# ------------------------------------------------------------------ torch


def _i32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (32 - n)) - 1)


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 16)
    h = h * _i32(0x7FEB352D)
    h = h ^ _shr(h, 15)
    h = h * _i32(0x846CA68B)
    return h ^ _shr(h, 16)


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return _shr(x, r) | (x << (32 - r))


def _draws(base: torch.Tensor, words: int) -> tuple[torch.Tensor, torch.Tensor]:
    offs = np.arange(2 * words, dtype=np.uint32) * np.uint32(GOLD)
    offs = torch.from_numpy(offs.view(np.int32)).to(base.device)
    d = _mix(base[:, None] + offs[None, :]).view(-1, words, 2)
    return d[..., 0], d[..., 1]


def rows_torch(row0: int, n: int, words: int, seed: int, device) -> torch.Tensor:
    """Rows ``[row0, row0 + n)`` as ``int32 (n, words)`` on ``device``, the
    same bits as :func:`rows_np`."""
    s_row, s_clu = (_i32(v) for v in seed_consts(seed))
    idx = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)
    idx = torch.where(idx >= 1 << 31, idx - (1 << 32), idx).to(torch.int32)
    c0 = row0 // CLUSTER_ROWS
    c1 = (row0 + n - 1) // CLUSTER_ROWS + 1
    clusters = torch.arange(c0, c1, dtype=torch.int64, device=device)
    clusters = clusters.to(torch.int32)
    ca, cb = _draws(_mix(clusters ^ s_clu), words)
    core = ca & _ror(ca, 7) & _ror(ca, 15) & cb & _ror(cb, 11)
    del ca, cb
    ra, rb = _draws(_mix(idx ^ s_row), words)
    keep = ra | _ror(ra, 13)
    del ra
    indiv = (rb & _ror(rb, 3) & _ror(rb, 6) & _ror(rb, 12) & _ror(rb, 17)
             & _ror(rb, 24))
    del rb
    return (core[(_shr(idx, 8) - _i32(c0)).long()] & keep) | indiv


def fold_torch(rows: torch.Tensor, fold: int) -> torch.Tensor:
    """:func:`fold_np` on int32 tensors."""
    if fold == 1:
        return rows
    g = rows.view(rows.shape[0], fold, rows.shape[1] // fold)
    out = g[:, 0]
    for i in range(1, fold):
        out = out | g[:, i]
    return out
