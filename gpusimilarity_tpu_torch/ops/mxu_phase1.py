"""Phase 1 of the dense scan as a matrix product (twin of
``gpusimilarity_tpu/ops/pallas_mxu.py``).

``popcount(a & b)`` is also the dot product of the two rows' unpacked 0/1
bits. :func:`mxu_phase1` computes it for a query batch against every column
of an unfolded planar dense store (``words (32, N)``, 1024-bit rows) on the
tensor cores, then scores, masks and reduces as the dense phase 1 does: per
query, the maximum score of every selection block of ``block`` columns and
the count of columns scoring >= the query's cutoff. The queries enter
unpacked, :func:`query_bits`, in word-major order ``w*32 + b``.

For CUDA tensors it launches the hand-written kernel ``csrc/mxu_phase1.cu``
or raises; it never falls back. The card multiplies packed bits directly
(the binary tensor-core product), so the kernel packs the query bits back
into words once per launch, takes the library words as they lie in the
store, and stages every library tile once for up to 128 queries. The TPU
kernel's choice between int8 and bf16 products has no counterpart there:
``int8_mxu`` is kept for the callers that pass it and selects nothing. For
CPU tensors it runs :func:`mxu_phase1_plain`, the plain PyTorch version of the same function, which the tests hold against
the JAX Pallas kernel and which the kernel matches bit for bit on the card.
No serving path calls it: the probe
(``python -m gpusimilarity_tpu_torch.tools.probe_mxu``) measures whether it
would pay.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .bitplane import shr
from .scan import TANIMOTO, TVERSKY, similarity_from_counts

WORDS = 32  # 1024-bit rows
BITS = 32 * WORDS
# queries per kernel launch; a larger batch runs in several launches
MAX_QUERIES = 128
# selection block widths the kernel takes: powers of two in [64, 256]
MIN_BLOCK, MAX_BLOCK = 64, 256

_LAUNCH_LOCK = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _LAUNCH_LOCK:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _LAUNCH_LOCK:
        _launches += 1


def query_bits(queries: torch.Tensor) -> torch.Tensor:
    """Packed queries int32 ``(B, 32)`` -> int8 ``(B, 1024)``: position
    ``w*32 + b`` holds bit ``b`` of word ``w`` (twin of ``query_bits_np``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=queries.device)
    bits = shr(queries[:, :, None], shifts) & 1
    return bits.to(torch.int8).reshape(queries.shape[0], -1)


def _column_bits(words: torch.Tensor) -> torch.Tensor:
    """Planar words int32 ``(32, C)`` -> float32 0/1 bits ``(1024, C)``,
    row ``w*32 + b`` = bit ``b`` of word ``w``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(BITS, words.shape[1]).to(torch.float32)


def mxu_phase1_plain(
    words: torch.Tensor,
    pops: torch.Tensor,
    qbits: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    alpha_beta: torch.Tensor,
    shard_offset: int,
    block: int,
    n_valid: int,
    similarity: str = TANIMOTO,
    int8_mxu: bool = True,
    chunk_cols: int = 1 << 18,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch phase 1: ``(block_max f32 (B, N/block), counts int64
    (B,))``.

    In column chunks of ``chunk_cols`` (about 1 GB of unpacked bits): the
    chunk's bits as a float32 ``(1024, chunk)`` matrix, ``common =
    qbits.float() @ bits`` (0/1 products and sums <= 1024 are exact in
    float32, and in TF32), scores as :func:`~.scan.similarity_from_counts`
    gives them, columns with ``shard_offset + col >= n_valid`` masked to
    -inf, block maxima and counts. ``int8_mxu`` (the TPU kernel's product
    type) changes no result, so the plain version ignores it.
    """
    del int8_mxu
    b = qbits.shape[0]
    n = words.shape[1]
    dev = words.device
    alpha, beta = (float(v) for v in alpha_beta.tolist())
    chunk = max(block, chunk_cols // block * block)
    q = qbits.to(torch.float32)
    block_max = torch.empty((b, n // block), dtype=torch.float32, device=dev)
    counts = torch.zeros(b, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        common = q @ _column_bits(words[:, c0:c1])
        s = similarity_from_counts(
            common, pops[c0:c1], query_pops, similarity, alpha, beta
        )
        cols = torch.arange(c0, c1, device=dev) + int(shard_offset)
        s = torch.where(cols < n_valid, s, float("-inf"))
        block_max[:, c0 // block:c1 // block] = s.view(b, -1, block).amax(dim=-1)
        counts += (s >= cutoffs[:, None]).sum(dim=-1)
    return block_max, counts


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from ..utils import kernels

        lib = kernels.load("mxu_phase1").lib
        fn = lib.gpusim_mxu_phase1
        ptr = ctypes.c_void_p
        ll, i32 = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr] * 9 + [ll, ll, i32, i32, ll, ll, i32, ptr]
        fn.restype = ctypes.c_int
        lib.gpusim_mxu_scratch_words.argtypes = [i32]
        lib.gpusim_mxu_scratch_words.restype = i32
        lib.gpusim_error_string.argtypes = [ctypes.c_int]
        lib.gpusim_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.gpusim_error_string, lib.gpusim_mxu_scratch_words)
    return _FN


def mxu_phase1_kernel(words, pops, qbits, query_pops, cutoffs, alpha_beta,
                      shard_offset, block, n_valid, similarity=TANIMOTO,
                      int8_mxu=True):
    """``csrc/mxu_phase1.cu`` on CUDA tensors already checked by
    :func:`mxu_phase1`: one launch per 128 queries, ``(block_max, counts)``
    as :func:`mxu_phase1_plain` returns them. ``words`` may be a column
    prefix of a wider store (its row stride is passed). ``int8_mxu`` selects
    nothing (the product is binary). Raises if a launch fails."""
    del int8_mxu
    if words.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {words.device}")
    n = words.shape[1]
    b = qbits.shape[0]
    fn, err, scratch_words = _kernel_fn()
    # scratch of the kernel's set-up pass: the queries packed back into words
    # in fragment order, and each query's cutoff as a rational threshold
    scratch = torch.empty(scratch_words(min(b, MAX_QUERIES)), dtype=torch.int32,
                          device=words.device)
    block_max = torch.empty((b, n // block), dtype=torch.float32, device=words.device)
    counts = torch.zeros(b, dtype=torch.int64, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    for q0 in range(0, b, MAX_QUERIES):
        q1 = min(b, q0 + MAX_QUERIES)
        # the C launcher works on the thread's current device: make it the
        # tensors' (a store on another card, a worker thread)
        with torch.cuda.device(words.device):
            rc = fn(
                words.data_ptr(), pops.data_ptr(), qbits[q0:q1].data_ptr(),
                query_pops[q0:q1].data_ptr(), cutoffs[q0:q1].data_ptr(),
                alpha_beta.data_ptr(), block_max[q0:q1].data_ptr(),
                counts[q0:q1].data_ptr(), scratch.data_ptr(), n,
                words.stride(0), q1 - q0, block, int(n_valid),
                int(shard_offset), int(similarity == TVERSKY), stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"mxu phase-1 kernel launch failed: {err(rc).decode()}"
            )
        _count_launch()
    return block_max, counts


def mxu_phase1(
    words: torch.Tensor,
    pops: torch.Tensor,
    qbits: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    alpha_beta: torch.Tensor,
    shard_offset: int,
    block: int,
    n_valid: int,
    similarity: str = TANIMOTO,
    int8_mxu: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 for a query batch, by matrix product.

    ``words`` int32 ``(32, N)`` planar, unit column stride (the unfolded
    dense store); ``pops`` int16 ``(N,)``, the store's popcounts;
    ``qbits`` int8 ``(B, 1024)`` from :func:`query_bits`; ``query_pops``
    int32 ``(B,)``; ``cutoffs`` f32 ``(B,)``; ``alpha_beta`` f32 ``(2,)``;
    ``shard_offset`` the global index of column 0 (0 on one card); ``block``
    a power of two from 64 to 256 that divides N. Columns with
    ``shard_offset + col >= n_valid`` score -inf. Returns ``(block_max f32
    (B, N/block), counts int64 (B,))``.
    """
    if similarity not in (TANIMOTO, TVERSKY):
        raise ValueError(f"unknown similarity {similarity!r}")
    w, n = words.shape
    if w != WORDS:
        raise ValueError(f"the matrix-product scan takes 1024-bit rows: {w} != {WORDS} words")
    if words.dtype != torch.int32 or words.stride(1) != 1:
        raise ValueError("words must be int32 (32, N) with unit column stride")
    b = qbits.shape[0]
    for t, dtype, shape in ((pops, torch.int16, (n,)), (qbits, torch.int8, (b, BITS)),
                            (query_pops, torch.int32, (b,)),
                            (cutoffs, torch.float32, (b,)),
                            (alpha_beta, torch.float32, (2,))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"expected contiguous {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != words.device:
            raise ValueError("all inputs must be on one device")
    if not MIN_BLOCK <= block <= MAX_BLOCK or block & (block - 1) or n % block:
        raise ValueError(
            f"block {block} must be a power of two in [{MIN_BLOCK}, "
            f"{MAX_BLOCK}] dividing {n}"
        )
    args = (words, pops, qbits, query_pops, cutoffs, alpha_beta, shard_offset,
            block, n_valid, similarity, int8_mxu)
    if words.device.type == "cuda":
        return mxu_phase1_kernel(*args)
    if words.device.type == "cpu":
        return mxu_phase1_plain(*args)
    raise ValueError(f"unsupported device {words.device}")
