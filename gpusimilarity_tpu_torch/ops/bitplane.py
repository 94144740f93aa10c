"""Bit-sliced (bitplane) intersection counting (twin of
``gpusimilarity_tpu/ops/bitplane.py``).

``common[n] = popcount(row_n & query)`` is also the sum, over the query's
set bits p, of bit p of row n. With the library stored bit-transposed —
plane p holds bit p of every row, packed 32 rows to a word — a query reads
only its ~30-60 set planes instead of all 32 words of every row.

Layout: ``planes int32[bitcount, n_cols / 32]``, plain plane-major in
global column order: bit i of word j of plane p is bit p of row
``32*j + i``. Words are int32 views of the packed ``uint32`` data.

The host helpers (bucket choice, query plane lists, the numpy transpose)
are numpy copies of the JAX package's; the device transpose and the
carry-save counter code work on int32 tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

# query set-bit lists are padded to a bucket size; a sentinel plane index
# (== bitcount) selects an all-zero plane and contributes nothing
PLANE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)

# device transpose granularity: 65536 plane words = 2Mi rows per step
_TRANSPOSE_CHUNK_WORDS = 1 << 16


def build_bitplanes_np(packed_rows: np.ndarray, n_cols: int) -> np.ndarray:
    """Transpose packed rows ``uint8[N, bytes]`` into padded bitplanes
    ``uint32[bitcount, n_cols // 32]`` on the host (padding columns zero)."""
    n, nbytes = packed_rows.shape
    bitcount = nbytes * 8
    if n_cols % 32 or n_cols < n:
        raise ValueError("n_cols must be a multiple of 32 and >= row count")
    out = np.zeros((bitcount, n_cols // 8), dtype=np.uint8)
    step = 1 << 20
    for start in range(0, n, step):
        stop = min(n, start + step)
        bits = np.unpackbits(packed_rows[start:stop], axis=1, bitorder="little")
        packed = np.packbits(
            np.ascontiguousarray(bits.T), axis=1, bitorder="little"
        )
        out[:, start // 8:(stop + 7) // 8] = packed
    return np.ascontiguousarray(out).view(np.uint32).reshape(bitcount, n_cols // 32)


def plane_bucket_for(max_set: int, bitcount: int) -> int:
    """Smallest plane bucket holding ``max_set`` set bits (cap: bitcount)."""
    bucket = next(
        (p for p in PLANE_BUCKETS if p >= max_set and p <= bitcount),
        bitcount,
    )
    return min(bucket, bitcount)


def query_plane_indices(
    query_words: np.ndarray, bitcount: int, bucket: int | None = None
) -> tuple[np.ndarray, int]:
    """Set-bit positions of packed queries ``uint32 (B, W)``, padded with
    the sentinel ``bitcount``: returns ``int32 (B, P)`` and P."""
    q = np.asarray(query_words, dtype=np.uint32)
    bits = np.unpackbits(q.view(np.uint8), axis=-1, bitorder="little")
    idx_lists = [np.nonzero(row)[0] for row in bits]
    max_set = max((len(i) for i in idx_lists), default=1)
    if bucket is None:
        bucket = plane_bucket_for(max_set, bitcount)
    bucket = min(bucket, bitcount)
    if max_set > bucket:
        raise ValueError(f"query has {max_set} bits set > bucket {bucket}")
    out = np.full((len(idx_lists), bucket), bitcount, dtype=np.int32)
    for b, idx in enumerate(idx_lists):
        out[b, : len(idx)] = idx
    return out, bucket


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> their int32 two's-complement view."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def shr(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int32-viewed ``uint32`` words by ``n`` (an int
    or an int tensor, 0..31): the arithmetic ``>>`` with the sign-filled
    high bits masked off."""
    if isinstance(n, torch.Tensor):
        mask = wrap_int32((1 << (32 - n.to(torch.int64))) - 1)
        n = n.to(torch.int32)
    else:
        mask = (1 << (32 - n)) - 1
        mask = mask - (1 << 32) if mask >= 1 << 31 else mask
    return (x >> n) & mask


def planes_from_rows(
    rows: torch.Tensor, n_cols: int, extra_planes: int = 0
) -> torch.Tensor:
    """Device transpose of packed rows ``int32 (N, W)`` into bitplanes
    ``int32 (32*W + extra_planes, n_cols // 32)``; padding columns and the
    ``extra_planes`` trailing planes are zero.

    Runs on the rows' device in slabs of 2Mi rows, so a 100M-row library
    transposes on the card in seconds instead of minutes of numpy.
    """
    n, w = rows.shape
    if n_cols % 32 or n_cols < n:
        raise ValueError("n_cols must be a multiple of 32 and >= row count")
    m = n_cols // 32
    dev = rows.device
    out = torch.zeros((32 * w + extra_planes, m), dtype=torch.int32, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << shifts.to(torch.int64)
    m_rows = -(-n // 32)  # plane words that hold any real row
    for w0 in range(0, m_rows, _TRANSPOSE_CHUNK_WORDS):
        w1 = min(m_rows, w0 + _TRANSPOSE_CHUNK_WORDS)
        blk = rows[32 * w0:min(n, 32 * w1)]
        if blk.shape[0] < 32 * (w1 - w0):
            pad = torch.zeros(
                (32 * (w1 - w0) - blk.shape[0], w), dtype=torch.int32, device=dev
            )
            blk = torch.cat([blk, pad])
        blk = blk.view(w1 - w0, 32, w)  # (plane word, row in word, row word)
        for wd in range(w):
            bits = (blk[:, :, wd, None] >> shifts) & 1  # (Mc, row i, bit j)
            words = (bits.to(torch.int64) * weights[None, :, None]).sum(dim=1)
            out[32 * wd:32 * (wd + 1), w0:w1] = wrap_int32(words).T
    return out


def wallace_popcount_planes(planes) -> list[torch.Tensor]:
    """Sum P single-bit planes into bit-sliced counters (Wallace tree).

    ``planes`` is a list of same-shape int32 tensors or one stacked
    ``(P, ...)`` tensor; each lane-bit holds a 0/1 addend. Returns counter
    planes ``[c0, c1, ...]`` where a lane-bit's count is
    ``sum_j bit(c_j) << j``. Each tree level runs as whole-tensor carry-save
    adds over all the wires of one weight at once.
    """
    if isinstance(planes, (list, tuple)):
        if not planes:
            raise ValueError("no planes")
        planes = torch.stack(list(planes))
    if planes.shape[0] == 0:
        raise ValueError("no planes")
    pending: list[list[torch.Tensor]] = [[planes]]
    result: list[torch.Tensor] = []
    weight = 0
    while weight < len(pending):
        wires = torch.cat(pending[weight])
        carries = []
        while wires.shape[0] > 2:
            g = wires.shape[0] // 3
            a, b, c = wires[0:3 * g:3], wires[1:3 * g:3], wires[2:3 * g:3]
            axb = a ^ b
            carries.append((a & b) | (axb & c))
            wires = torch.cat([axb ^ c, wires[3 * g:]])
        if wires.shape[0] == 2:  # half adder
            carries.append(wires[0:1] & wires[1:2])
            wires = wires[0:1] ^ wires[1:2]
        if carries:
            if weight + 1 >= len(pending):
                pending.append([])
            pending[weight + 1].extend(carries)
        result.append(wires[0])
        weight += 1
    return result


def counters_to_counts(counters: list[torch.Tensor]) -> torch.Tensor:
    """Expand bit-sliced counters ``[(..., M) int32, ...]`` to
    ``int32 (..., M*32)``: lane-bit i of word j is row ``32*j + i``."""
    c0 = counters[0]
    shifts = torch.arange(32, dtype=torch.int32, device=c0.device)
    total = torch.zeros((*c0.shape, 32), dtype=torch.int32, device=c0.device)
    for j, c in enumerate(counters):
        total += (shr(c[..., None], shifts) & 1) << j
    return total.reshape(*c0.shape[:-1], c0.shape[-1] * 32)
