"""The device half of the virtual library (twin of the device code in
``gpusimilarity_tpu/utils/synth.py``).

A virtual library row is a pure function of its index through the
``lowbias32`` counter mixer, so the card can generate a 10^9-row library in
place while the host recomputes only the few rows a folded search rescores
(``gpusimilarity_tpu.utils.synth.virtual_rows_np`` and ``VirtualWords``,
which the port imports: they are jax-free).

PyTorch has no unsigned 32-bit arithmetic, so the mixer runs on int32
views: addition, multiplication and left shifts wrap modulo 2**32 the same
way on either view, ``^ & |`` are bitwise, and the logical right shift is
:func:`~..ops.bitplane.shr`. ``tests/test_torch_synth.py`` pins the result
against ``virtual_rows_np``, including rows past 2**31.
"""

from __future__ import annotations

import numpy as np
import torch

from gpusimilarity_tpu.utils.synth import (
    CLUSTER_ROWS,
    NUM_DRAWS,
    _GOLD,
    _seed_consts,
    virtual_rows_np,
)

from ..ops import fold as fold_ops
from ..ops.bitplane import shr, wrap_int32
from ..ops.scan import popcount_rows, popcount_rows_np
from ..parallel.sharded import DenseStore, plan_store_layout

# rows generated per step on the device (a multiple of CLUSTER_ROWS)
_GEN_ROWS = 1 << 20


def _i32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


_C1, _C2 = _i32(0x7FEB352D), _i32(0x846CA68B)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int32-viewed uint32 words."""
    h = h ^ shr(h, 16)
    h = h * _C1
    h = h ^ shr(h, 15)
    h = h * _C2
    return h ^ shr(h, 16)


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return shr(x, r) | (x << (32 - r))


def _draws(base: torch.Tensor, word_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two mixer draws of every word over per-row bases ``(K,)``:
    ``a, b`` int32 ``(K, word_count)``."""
    wd = np.arange(word_count * NUM_DRAWS, dtype=np.uint32) * np.uint32(_GOLD)
    wd = torch.from_numpy(wd.view(np.int32)).to(base.device)
    d = _mix32(base[:, None] + wd[None, :]).view(-1, word_count, NUM_DRAWS)
    return d[..., 0], d[..., 1]


def virtual_rows(
    row0: int, n: int, word_count: int = 32, seed: int = 0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Full-width rows ``[row0, row0 + n)`` as int32 ``(n, word_count)`` on
    ``device``: the same bits as ``virtual_rows_np(arange(row0, row0 + n))``
    (torch twin of ``_virtual_rows_jnp`` / ``_virtual_words``).

    The cluster draws are computed once per 256-row cluster and shared by
    its rows; the row draws once per row. The words are combined as in
    ``_combine_words``.
    """
    if not 0 <= row0 <= row0 + n <= 1 << 32:
        raise ValueError("rows must lie in [0, 2**32)")
    s_row, s_clu = (_i32(int(v)) for v in _seed_consts(seed))
    idx = wrap_int32(torch.arange(row0, row0 + n, device=device))
    c0 = row0 // CLUSTER_ROWS
    clusters = torch.arange(
        c0, (row0 + n - 1) // CLUSTER_ROWS + 1, dtype=torch.int32, device=device
    )
    ca, cb = _draws(_mix32(clusters ^ s_clu), word_count)
    core = ca & _ror(ca, 7) & _ror(ca, 15) & cb & _ror(cb, 11)
    ra, rb = _draws(_mix32(idx ^ s_row), word_count)
    keep = ra | _ror(ra, 13)
    indiv = (
        rb & _ror(rb, 3) & _ror(rb, 6) & _ror(rb, 12) & _ror(rb, 17)
        & _ror(rb, 24)
    )
    return (core[(shr(idx, 8) - c0).long()] & keep) | indiv


def virtual_folded_rows(
    n_rows: int, fold_factor: int, word_count: int = 32, seed: int = 0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """The first ``n_rows`` virtual rows OR-folded, int32 ``(n_rows,
    word_count // fold)`` on ``device``, generated in steps of 1Mi rows so
    the full width never exists whole. ``build_bitplane_store`` takes it
    for a folded virtual bitplane library."""
    wf = word_count // fold_factor
    out = torch.empty((n_rows, wf), dtype=torch.int32, device=device)
    for lo in range(0, n_rows, _GEN_ROWS):
        hi = min(n_rows, lo + _GEN_ROWS)
        out[lo:hi] = fold_ops.fold_words(
            virtual_rows(lo, hi - lo, word_count, seed, device), fold_factor
        )
    return out


def build_virtual_dense_store(
    n_rows: int,
    fold_factor: int,
    word_count: int = 32,
    seed: int = 0,
    popless: bool = True,
    device: torch.device | str = "cpu",
) -> DenseStore:
    """Generate the folded virtual library directly on the device as a
    dense store (twin of ``build_virtual_dense_store``): each step makes
    1Mi full-width rows, OR-folds them and writes their columns (and
    popcounts, unless ``popless``) in place. Peak transient memory is a few
    hundred MB at any library size. Padding columns stay zero; the scan's
    ``n_valid`` mask excludes them.
    """
    if word_count % fold_factor:
        raise ValueError("fold factor must divide the word count")
    wf = word_count // fold_factor
    n_padded = plan_store_layout(n_rows)
    words = torch.zeros((wf, n_padded), dtype=torch.int32, device=device)
    pops = None if popless else torch.zeros(n_padded, dtype=torch.int16, device=device)
    for lo in range(0, n_rows, _GEN_ROWS):
        hi = min(n_rows, lo + _GEN_ROWS)
        folded = fold_ops.fold_words(
            virtual_rows(lo, hi - lo, word_count, seed, device), fold_factor
        )
        words[:, lo:hi] = folded.T
        if pops is not None:
            pops[lo:hi] = popcount_rows(folded).to(torch.int16)
    return DenseStore(words=words, popcounts=pops, n_valid=n_rows)


def pick_query_rows(
    count: int,
    n_rows: int,
    fold_factor: int,
    word_count: int = 32,
    seed: int = 0,
    max_planes: int = 64,
    rng_seed: int = 123,
) -> np.ndarray:
    """Library rows usable as queries: rows whose folded popcount is at
    most ``max_planes``, drawn as the JAX ``pick_query_rows`` draws them
    (same rows for the same arguments). Each is a cluster member, so it
    has graded neighbours in the library."""
    rng = np.random.default_rng(rng_seed)
    picked: list[int] = []
    while len(picked) < count:
        cand = rng.choice(n_rows, size=4 * count, replace=False)
        rows = virtual_rows_np(cand, word_count=word_count, seed=seed)
        fp = popcount_rows_np(fold_ops.fold_words(rows, fold_factor))
        picked.extend(int(c) for c, p in zip(cand, fp) if p <= max_planes)
    return np.array(picked[:count], dtype=np.int64)


__all__ = [
    "build_virtual_dense_store",
    "pick_query_rows",
    "virtual_folded_rows",
    "virtual_rows",
    "virtual_rows_np",
]
