"""Phase 1 of the dense scan (twin of ``gpusimilarity_tpu/ops/pallas_scan.py``).

:func:`dense_phase1` scores a query batch against every column of a planar
dense store ``(Wf, N)`` and returns, per query, the maximum score of every
selection block of ``block`` consecutive columns and the count of valid
columns scoring >= the query's cutoff. Nothing per column leaves the
kernel.

For CUDA tensors it launches the hand-written kernel
``csrc/dense_phase1.cu`` (intersection counts from the binary tensor-core
product, an integer Tanimoto epilogue) or raises; it never falls back. For CPU tensors it
runs :func:`dense_phase1_plain`, the plain PyTorch version of the same
function, which the tests hold against the JAX Pallas kernel and which the
kernel matches bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .scan import TANIMOTO, TVERSKY, score_columns

# the selection blocks the kernel takes: a power of two of whole 8-column
# tiles of the tensor-core product (the plain version takes 1..MAX_BLOCK)
KERNEL_MIN_BLOCK, MAX_BLOCK = 8, 256
# the widest row the kernel takes: 64 packed words, 2048 bits (its integer
# epilogue is proven to that width; the plain version takes any)
KERNEL_MAX_WORDS = 64
# the queries one launch of the kernel takes; the C entry walks a larger
# batch in slices of this many (its cutoff table has to fit in shared
# memory), 16 at rows over 32 words (gpusim_dense_phase1_max_queries)
KERNEL_MAX_QUERIES, KERNEL_MAX_QUERIES_WIDE = 32, 16

_LAUNCH_LOCK = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _LAUNCH_LOCK:
        _launches = 0


def kernel_launches(b: int, wf: int) -> int:
    """The kernel launches one call makes for ``b`` queries of ``wf`` words:
    one per slice of the batch."""
    per_launch = KERNEL_MAX_QUERIES if wf <= 32 else KERNEL_MAX_QUERIES_WIDE
    return -(-b // per_launch)


def _count_launches(n: int) -> None:
    global _launches
    with _LAUNCH_LOCK:
        _launches += n


def dense_phase1_plain(
    words: torch.Tensor,
    pops: torch.Tensor | None,
    queries: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    alpha_beta: torch.Tensor,
    n_valid: int,
    block: int,
    similarity: str = TANIMOTO,
    chunk_cols: int = 1 << 21,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch phase 1: ``(block_max f32 (B, N/block), counts int64
    (B,))``.

    The whole batch at once, in column chunks of ``chunk_cols`` so the
    ``(B, chunk)`` temporaries stay small at 10^9 columns: score the chunk
    (:func:`score_columns`, popcounts recomputed when ``pops`` is None),
    mask columns ``>= n_valid`` to -inf, reduce block maxima and counts.
    """
    b = queries.shape[0]
    n = words.shape[1]
    dev = words.device
    alpha, beta = (float(v) for v in alpha_beta.tolist())
    chunk = max(block, chunk_cols // block * block)
    block_max = torch.empty((b, n // block), dtype=torch.float32, device=dev)
    counts = torch.zeros(b, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        s = score_columns(
            words[:, c0:c1], None if pops is None else pops[c0:c1], queries,
            query_pops, similarity, alpha, beta,
        )
        cols = torch.arange(c0, c1, device=dev)
        s = torch.where(cols < n_valid, s, float("-inf"))
        block_max[:, c0 // block:c1 // block] = s.view(b, -1, block).amax(dim=-1)
        counts += (s >= cutoffs[:, None]).sum(dim=-1)
    return block_max, counts


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from ..utils import kernels

        lib = kernels.load("dense_phase1").lib
        fn = lib.gpusim_dense_phase1
        ptr = ctypes.c_void_p
        ll, i32 = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [ll, ll, i32, i32, i32, ll, i32, ptr]
        fn.restype = ctypes.c_int
        lib.gpusim_error_string.argtypes = [ctypes.c_int]
        lib.gpusim_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.gpusim_error_string)
    return _FN


def dense_phase1_kernel(words, pops, queries, query_pops, cutoffs, alpha_beta,
                        n_valid, block, similarity=TANIMOTO):
    """One launch of ``csrc/dense_phase1.cu`` on CUDA tensors already
    checked by :func:`dense_phase1`: ``(block_max, counts)`` as
    :func:`dense_phase1_plain` returns them. ``words`` may be a column
    prefix of a wider store (its row stride is passed). Raises if
    ``block`` is under :data:`KERNEL_MIN_BLOCK`, a row has more than
    :data:`KERNEL_MAX_WORDS` words or the launch fails."""
    if words.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {words.device}")
    if block < KERNEL_MIN_BLOCK:
        raise ValueError(
            f"the kernel needs a block of >= {KERNEL_MIN_BLOCK} columns, got {block}"
        )
    wf, n = words.shape
    if wf > KERNEL_MAX_WORDS:
        raise ValueError(
            f"the kernel takes rows of at most {KERNEL_MAX_WORDS} words "
            f"({32 * KERNEL_MAX_WORDS} bits), got {wf}"
        )
    b = queries.shape[0]
    fn, err = _kernel_fn()
    block_max = torch.empty((b, n // block), dtype=torch.float32, device=words.device)
    counts = torch.zeros(b, dtype=torch.int64, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    # the C launcher works on the thread's current device: make it the
    # tensors' (a shard on another card, a worker thread)
    with torch.cuda.device(words.device):
        rc = fn(
            words.data_ptr(), 0 if pops is None else pops.data_ptr(),
            queries.data_ptr(), query_pops.data_ptr(), cutoffs.data_ptr(),
            alpha_beta.data_ptr(), block_max.data_ptr(), counts.data_ptr(),
            n, words.stride(0), wf, b, block, int(n_valid),
            int(similarity == TVERSKY), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"dense phase-1 kernel launch failed: {err(rc).decode()}"
        )
    _count_launches(kernel_launches(b, wf))
    return block_max, counts


def dense_phase1(
    words: torch.Tensor,
    pops: torch.Tensor | None,
    queries: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    alpha_beta: torch.Tensor,
    n_valid: int,
    block: int,
    similarity: str = TANIMOTO,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 for a query batch.

    ``words`` int32 ``(Wf, N)`` planar, unit column stride; ``pops`` int16
    ``(N,)`` or None for a popless store; ``queries`` int32 ``(B, Wf)``;
    ``query_pops`` int32 ``(B,)``; ``cutoffs`` f32 ``(B,)``;
    ``alpha_beta`` f32 ``(2,)``; ``block`` a power of two up to 256 that
    divides N (on the card at least 8). Returns ``(block_max f32 (B,
    N/block), counts int64 (B,))``.

    ``pops`` and ``query_pops`` must be the true popcounts of the words
    they stand for, as the store builders and the engine give them. The
    kernel's integer epilogue relies on ``common <= min(query_pop, pop)``;
    with inconsistent popcounts it and the plain version may differ.
    """
    if similarity not in (TANIMOTO, TVERSKY):
        raise ValueError(f"unknown similarity {similarity!r}")
    wf, n = words.shape
    b = queries.shape[0]
    if words.dtype != torch.int32 or words.stride(1) != 1:
        raise ValueError("words must be int32 (Wf, N) with unit column stride")
    args = [(queries, torch.int32, (b, wf)), (query_pops, torch.int32, (b,)),
            (cutoffs, torch.float32, (b,)), (alpha_beta, torch.float32, (2,))]
    if pops is not None:
        args.append((pops, torch.int16, (n,)))
    for t, dtype, shape in args:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"expected contiguous {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != words.device:
            raise ValueError("all inputs must be on one device")
    if not 1 <= block <= MAX_BLOCK or block & (block - 1) or n % block:
        raise ValueError(
            f"block {block} must be a power of two <= {MAX_BLOCK} dividing {n}"
        )
    args = (words, pops, queries, query_pops, cutoffs, alpha_beta, n_valid, block,
            similarity)
    if words.device.type == "cuda":
        return dense_phase1_kernel(*args)
    if words.device.type == "cpu":
        return dense_phase1_plain(*args)
    raise ValueError(f"unsupported device {words.device}")
