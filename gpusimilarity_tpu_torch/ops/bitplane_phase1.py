"""Phase 1 of the bitplane scan (twin of
``gpusimilarity_tpu/ops/pallas_bitplane.py``).

:func:`bitplane_phase1_batched` scores a query batch against every column
of a bitplane store and returns, per query, the maximum score of every
32-column word (``colmax``), the maximum of every selection block, and the
count of valid columns scoring >= the query's cutoff.

For CUDA tensors it launches the hand-written kernel
``csrc/bitplane_phase1.cu`` or raises; it never falls back. For CPU tensors
it runs :func:`bitplane_phase1_plain`, the plain PyTorch version of the
same function, which the tests hold against the JAX kernel and which the
kernel matches bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import kernels
from .bitplane import counters_to_counts, wallace_popcount_planes
from .scan import TANIMOTO, TVERSKY, similarity_from_counts

KERNEL = "bitplane_phase1"  # csrc/bitplane_phase1.cu

# selection block: 2048 columns = 64 plane words
BLOCK_WORDS = 64
# the longest plane list the kernel takes per query (its count fields have
# at most 12 bits); the plain version takes any
KERNEL_MAX_PLANES = 4095


def bitplane_phase1_plain(
    planes: torch.Tensor,
    pops: torch.Tensor,
    plane_idx: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    alpha_beta: torch.Tensor,
    n_valid: int,
    similarity: str = TANIMOTO,
    chunk_words: int = 1 << 18,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch phase 1: ``(colmax f32 (B, M), counts int32 (B,))``.

    One query at a time, in column chunks of ``chunk_words`` plane words so
    the per-column temporaries stay small at 100M+ rows: gather the query's
    planes, sum them with the carry-save tree, expand to per-column counts,
    score, mask columns ``>= n_valid`` to -inf.
    """
    b = plane_idx.shape[0]
    m = planes.shape[1]
    dev = planes.device
    alpha, beta = (float(v) for v in alpha_beta.tolist())
    colmax = torch.empty((b, m), dtype=torch.float32, device=dev)
    counts = torch.zeros(b, dtype=torch.int64, device=dev)
    for q in range(b):
        idx = plane_idx[q].to(torch.int64)
        for w0 in range(0, m, chunk_words):
            w1 = min(m, w0 + chunk_words)
            common = counters_to_counts(
                wallace_popcount_planes(planes[idx, w0:w1])
            )
            s = similarity_from_counts(
                common, pops[32 * w0:32 * w1], query_pops[q], similarity,
                alpha, beta,
            )
            cols = torch.arange(32 * w0, 32 * w1, device=dev)
            s = torch.where(cols < n_valid, s, float("-inf"))
            colmax[q, w0:w1] = s.view(w1 - w0, 32).amax(dim=-1)
            counts[q] += (s >= cutoffs[q]).sum()
    return colmax, counts.to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 10 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


def bitplane_phase1_kernel(planes, pops, plane_idx, query_pops, cutoffs,
                           alpha_beta, n_valid, similarity=TANIMOTO):
    """One launch of ``csrc/bitplane_phase1.cu`` on CUDA tensors already
    checked by :func:`bitplane_phase1_batched`: ``(colmax, counts)`` as
    :func:`bitplane_phase1_plain` returns them. ``pops`` and ``query_pops``
    must be the popcounts of the rows and queries the planes and lists stand
    for (the integer epilogue relies on ``common <= min`` of the two). Raises
    if the launch fails."""
    if planes.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {planes.device}")
    b, p = plane_idx.shape
    m = planes.shape[1]
    if pops.data_ptr() % 16 or planes.data_ptr() % 16 or m % 4:
        raise ValueError(
            "planes and pops must be 16-byte aligned and the plane width a "
            "multiple of 4 for the kernel's loads"
        )
    if p > KERNEL_MAX_PLANES:
        raise ValueError(
            f"plane bucket {p} > {KERNEL_MAX_PLANES} is not supported"
        )
    fn = kernels.bind(KERNEL, "gpusim_bitplane_phase1", _ARGTYPES)
    scratch_entries = kernels.bind(KERNEL, "gpusim_bitplane_scratch_entries",
                                   [ctypes.c_int] * 3)
    tversky = int(similarity == TVERSKY)
    colmax = torch.empty((b, m), dtype=torch.float32, device=planes.device)
    counts = torch.zeros(b, dtype=torch.int32, device=planes.device)
    # scratch of the kernel's set-up pass: per query its compacted plane list
    # and count table, and the list's length
    lists = torch.empty((b, scratch_entries(p, planes.shape[0], tversky)),
                        dtype=torch.int16, device=planes.device)
    lens = torch.empty(b, dtype=torch.int32, device=planes.device)
    kernels.launch(
        KERNEL, fn, planes.device,
        planes.data_ptr(), pops.data_ptr(), plane_idx.data_ptr(),
        query_pops.data_ptr(), cutoffs.data_ptr(), alpha_beta.data_ptr(),
        colmax.data_ptr(), counts.data_ptr(), lists.data_ptr(),
        lens.data_ptr(), m, b, p, planes.shape[0], int(n_valid), tversky,
    )
    return colmax, counts


def bitplane_phase1_batched(
    planes: torch.Tensor,
    pops: torch.Tensor,
    plane_idx: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    alpha_beta: torch.Tensor,
    n_valid: int,
    similarity: str = TANIMOTO,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1 for a query batch.

    ``planes`` int32 ``(bitcount + 1, M)`` with the zero sentinel plane
    last, ``pops`` int16 ``(32*M,)``, ``plane_idx`` int32 ``(B, P)``,
    ``query_pops`` int32 ``(B,)``, ``cutoffs`` f32 ``(B,)``, ``alpha_beta``
    f32 ``(2,)``; M a multiple of 64. Returns ``(block_max f32 (B, M/64),
    counts int32 (B,), colmax f32 (B, M))``.

    ``pops`` and ``query_pops`` must be the true popcounts of the rows the
    planes hold and of the bits ``plane_idx`` lists, as the store builders
    and the engine give them. The kernel's integer epilogue relies on
    ``common <= min(query_pop, pop)``; with inconsistent popcounts it and
    the plain version may differ.
    """
    if similarity not in (TANIMOTO, TVERSKY):
        raise ValueError(f"unknown similarity {similarity!r}")
    b, _ = plane_idx.shape
    m = planes.shape[1]
    args = (planes, pops, plane_idx, query_pops, cutoffs, alpha_beta)
    kernels.check_inputs(zip(
        args,
        (torch.int32, torch.int16, torch.int32, torch.int32, torch.float32,
         torch.float32),
        ((planes.shape[0], m), (32 * m,), (b, plane_idx.shape[1]), (b,), (b,),
         (2,)),
    ))
    if m % BLOCK_WORDS:
        raise ValueError(f"plane width {m} is not a multiple of {BLOCK_WORDS}")
    if planes.device.type == "cuda":
        colmax, counts = bitplane_phase1_kernel(*args, n_valid, similarity)
    elif planes.device.type == "cpu":
        colmax, counts = bitplane_phase1_plain(*args, n_valid, similarity)
    else:
        raise ValueError(f"unsupported device {planes.device}")
    block_max = colmax.view(b, m // BLOCK_WORDS, BLOCK_WORDS).amax(dim=-1)
    return block_max, counts, colmax
