"""The integer epilogue of the phase-1 CUDA kernels, stated in plain PyTorch.

The kernels (``csrc/dense_phase1.cu``, ``csrc/bitplane_phase1.cu``, through
``csrc/mxu_phase1.cu``, through ``csrc/phase1_epilogue.cuh``) do not divide
per (query, column) for Tanimoto. They rely on three facts about the correctly rounded float32
divide of :func:`~.scan.similarity_from_counts`, all consequences of its
being monotone:

* for a fixed query and column popcount the score ``c / (qpop + pop - c)``
  is non-decreasing in the intersection count ``c``, so ``score >= cutoff``
  is ``c >= cmin[pop]`` for a table built with that very divide
  (:func:`cutoff_threshold_table`);
* the maximum of the rounded scores of a block is the rounded score of the
  block's largest rational ``c / den``, which integer cross-multiplication
  finds exactly (:func:`rational_block_max`);
* the score depends on ``(c, pop)`` only through the rational ``c / d`` with
  ``d = max(qpop, 1) + pop - c``, so one fraction ``P / Q`` per query, the
  smallest with a denominator up to the largest ``d`` whose rounded value
  reaches the cutoff, decides ``score >= cutoff`` for every ``pop`` at once
  as ``c * Q >= P * d`` (:func:`tanimoto_threshold`; the matrix-product
  kernel's count test, where 128 tables would not fit in shared memory).

Nothing here runs on a serving path: the plain versions of the kernels
divide per column. These functions exist so the CPU tests can hold the
kernels' arithmetic to the per-column divide exhaustively
(``tests/test_torch_epilogue.py``).
"""

from __future__ import annotations

import torch

from .scan import similarity_from_counts

# table entry of a (query, pop) pair that no count can satisfy
NEVER = 0xFFFF


def cutoff_threshold_table(qpop: int, cutoff: float, bits: int) -> torch.Tensor:
    """``cmin int32 (bits + 1,)``: for each column popcount ``pop`` the
    smallest ``c`` in ``[0, min(qpop, pop)]`` whose Tanimoto score is
    ``>= cutoff``, or :data:`NEVER`. Built from the definition (the first
    count that satisfies it), with the plain version's divide."""
    pop = torch.arange(bits + 1, dtype=torch.int32)
    c = torch.arange(min(qpop, bits) + 1, dtype=torch.int32)
    scores = similarity_from_counts(
        c[None, :].expand(bits + 1, -1), pop[:, None], torch.tensor(qpop)
    )
    ok = (scores >= torch.tensor(cutoff, dtype=torch.float32)) & (
        c[None, :] <= pop[:, None]
    )
    first = ok.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(ok.any(dim=1), first, NEVER)


def tanimoto_threshold(cutoff: float, max_den: int) -> tuple[int, int]:
    """``(P, Q)``: the smallest fraction ``c / d`` with ``0 <= c <= d`` and
    ``1 <= d <= max_den`` whose float32 quotient is ``>= cutoff``, found from
    the definition with the plain version's divide. ``(0, 1)`` for a cutoff
    ``<= 0`` (every count satisfies it) and ``(1, 0)`` when no fraction does
    (a cutoff above 1, or NaN): ``c * Q >= P * d`` is then false for every
    ``d >= 1``. For a query of ``qpop`` set bits over rows of ``bits`` bits,
    ``max_den = max(qpop, 1) + bits`` covers every denominator."""
    cut = torch.tensor(cutoff, dtype=torch.float32)
    if cutoff <= 0:
        return 0, 1
    d = torch.arange(1, max_den + 1, dtype=torch.float32)[:, None]
    c = torch.arange(0, max_den + 1, dtype=torch.float32)[None, :]
    ok = ((c / d) >= cut) & (c <= d)
    if not ok.any():
        return 1, 0
    first = ok.to(torch.int32).argmax(dim=1)
    # fractions with denominators <= 2048 differ by > 2e-7: float64 orders them
    value = torch.where(ok.any(dim=1), first.double() / d[:, 0].double(), 2.0)
    best = int(value.argmin())
    return int(first[best]), best + 1


def rational_block_max(
    c: torch.Tensor, pop: torch.Tensor, qpop: int, block: int, n_valid: int
) -> torch.Tensor:
    """Block maxima of Tanimoto scores without a divide per column.

    ``c`` and ``pop`` int32 ``(N,)`` (intersection counts and column
    popcounts, ``c <= min(qpop, pop)``), ``N`` a multiple of ``block``;
    columns ``>= n_valid`` are invalid. Keeps per block the incumbent
    ``(num, den)``, replaced when ``c * den > num * d`` in integers, with
    ``d = max(qpop, 1) + pop - c`` (the plain version's
    ``max(qpop + pop - c, 1)`` wherever it matters) and an invalid column
    offered as ``c = -1``; then one divide per block, ``-inf`` for a block
    with no valid column. Returns f32 ``(N / block,)``, bit-identical to
    ``amax`` over the per-column divides."""
    n = c.shape[0]
    cols = torch.arange(n).view(-1, block)
    c = c.to(torch.int64).view(-1, block)
    den = max(int(qpop), 1) + pop.to(torch.int64).view(-1, block) - c
    offered = torch.where(cols < n_valid, c, -1)
    num_best = torch.full((n // block,), -1, dtype=torch.int64)
    den_best = torch.ones(n // block, dtype=torch.int64)
    for i in range(block):
        better = offered[:, i] * den_best > num_best * den[:, i]
        num_best = torch.where(better, offered[:, i], num_best)
        den_best = torch.where(better, den[:, i], den_best)
    score = num_best.to(torch.float32) / den_best.to(torch.float32)
    score = torch.where(num_best == den_best, 1.0, score)
    return torch.where(num_best < 0, float("-inf"), score)
