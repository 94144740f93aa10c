"""Selection stage 3 of the bitplane search: the exact scores of the 32
columns of each selected plane word (the rescore inside
``gpusimilarity_tpu/parallel/sharded.py::per_query_wordsel``).

:func:`bitplane_rescore` gathers each query's plane words at its selected
words, counts every column's common bits, scores the columns and masks
those ``>= n_valid`` to -inf. For CUDA tensors it launches the hand-written
kernel ``csrc/bitplane_rescore.cu`` once for the whole batch, or raises; it
never falls back. For CPU tensors it runs :func:`bitplane_rescore_plain`,
the chain of PyTorch ops (carry-save plane sums, per-column counts,
``similarity_from_counts``) that the tests hold the kernel against bit for
bit on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import kernels
from .bitplane import counters_to_counts, wallace_popcount_planes
from .bitplane_phase1 import KERNEL_MAX_PLANES
from .scan import TANIMOTO, TVERSKY, similarity_from_counts

KERNEL = "bitplane_rescore"  # csrc/bitplane_rescore.cu


def bitplane_rescore_plain(planes, pops, plane_idx, query_pops, w_sel, n_valid,
                           similarity=TANIMOTO, alpha=1.0, beta=1.0):
    """Plain PyTorch stage 3: ``(scores f32 (B, kw*32), cols int64 (B,
    kw*32))``, column ``32 * w_sel[b, j] + i`` at ``[b, 32 * j + i]``."""
    # (P, B, kw) plane words
    pw = planes[plane_idx.to(torch.int64).T[:, :, None], w_sel[None, :, :]]
    common = counters_to_counts(wallace_popcount_planes(pw))  # (B, kw*32)
    cols = (
        w_sel[:, :, None] * 32 + torch.arange(32, device=planes.device)
    ).reshape(w_sel.shape[0], -1)
    s = similarity_from_counts(
        common, pops[cols], query_pops, similarity, alpha, beta
    )
    return torch.where(cols < n_valid, s, float("-inf")), cols


_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
]


def bitplane_rescore_kernel(planes, pops, plane_idx, query_pops, w_sel,
                            n_valid, similarity=TANIMOTO, alpha=1.0, beta=1.0):
    """One launch of ``csrc/bitplane_rescore.cu`` on CUDA tensors already
    checked by :func:`bitplane_rescore`: ``(scores, cols)`` as
    :func:`bitplane_rescore_plain` returns them. Raises on a plane list
    longer than the kernel takes or if the launch fails."""
    b, p = plane_idx.shape
    kw = w_sel.shape[1]
    if p > KERNEL_MAX_PLANES:
        raise ValueError(
            f"plane bucket {p} > {KERNEL_MAX_PLANES} is not supported"
        )
    if planes.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {planes.device}")
    scores = torch.empty((b, 32 * kw), dtype=torch.float32, device=planes.device)
    cols = torch.empty((b, 32 * kw), dtype=torch.int64, device=planes.device)
    if b == 0 or kw == 0:
        return scores, cols
    kernels.launch(
        KERNEL, kernels.bind(KERNEL, "gpusim_bitplane_rescore", _ARGTYPES),
        planes.device,
        planes.data_ptr(), pops.data_ptr(), plane_idx.data_ptr(),
        query_pops.data_ptr(), w_sel.data_ptr(), scores.data_ptr(),
        cols.data_ptr(), planes.shape[1], planes.shape[0], b, p, kw,
        int(n_valid), int(similarity == TVERSKY), alpha, beta,
    )
    return scores, cols


def bitplane_rescore(
    planes: torch.Tensor,
    pops: torch.Tensor,
    plane_idx: torch.Tensor,
    query_pops: torch.Tensor,
    w_sel: torch.Tensor,
    n_valid: int,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3 for a query batch.

    ``planes`` int32 ``(bitcount + 1, M)`` with the zero sentinel plane
    last, ``pops`` int16 ``(32*M,)``, ``plane_idx`` int32 ``(B, P)``,
    ``query_pops`` int32 ``(B,)``, ``w_sel`` int64 ``(B, kw)`` word indices
    in ``[0, M)``. Returns ``(scores f32 (B, kw*32), cols int64 (B,
    kw*32))``: column ``32 * w_sel[b, j] + i`` and its score at ``[b, 32 *
    j + i]``, -inf from ``n_valid`` on.
    """
    if similarity not in (TANIMOTO, TVERSKY):
        raise ValueError(f"unknown similarity {similarity!r}")
    b, p = plane_idx.shape
    m = planes.shape[1]
    args = (planes, pops, plane_idx, query_pops, w_sel)
    kernels.check_inputs(zip(
        args,
        (torch.int32, torch.int16, torch.int32, torch.int32, torch.int64),
        ((planes.shape[0], m), (32 * m,), (b, p), (b,), (b, w_sel.shape[-1])),
    ))
    if planes.device.type == "cuda":
        return bitplane_rescore_kernel(*args, n_valid, similarity, alpha, beta)
    if planes.device.type == "cpu":
        return bitplane_rescore_plain(*args, n_valid, similarity, alpha, beta)
    raise ValueError(f"unsupported device {planes.device}")
