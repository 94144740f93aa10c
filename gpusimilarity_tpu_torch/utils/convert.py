"""Carry a library over from the JAX package: this system's counterpart of
converting checkpoint weights.

:func:`bitplane_store_from_jax` takes the host copies of a JAX
``BitplaneStore``'s arrays (``np.asarray(store.planes)``,
``np.asarray(store.popcounts)``), undoes its per-shard 8-sub-row interleave
(``gpusimilarity_tpu/parallel/sharded.py:472-481``) and trims its padding to
the port's layout, so both packages can score one library.
:func:`dense_store_from_jax` does the same for a JAX dense ``ShardedStore``
(``np.asarray(store.words)``, ``np.asarray(store.popcounts)`` or None).
:func:`store_from_fingerprint_data` builds the bitplane store from the data.
"""

from __future__ import annotations

import numpy as np
import torch

from gpusimilarity_tpu.utils.fsim import FingerprintData

from ..parallel.sharded import (
    BitplaneStore,
    DenseStore,
    build_bitplane_store,
    plan_bitplane_layout,
    plan_store_layout,
)


def dense_store_from_jax(
    words_np: np.ndarray,
    popcounts_np: np.ndarray | None,
    n_valid: int,
    device: torch.device | str = "cpu",
) -> DenseStore:
    """Port layout from a JAX dense store of any shard count.

    ``words_np`` is the global ``uint32 (Wf, n_padded_jax)`` planar array:
    the JAX store shards columns in global order, so column j is row j and
    only the padding differs. It is cut (or zero-padded) to the port's
    padded width; ``popcounts_np`` likewise, or None for a popless store.
    """
    wf, width = words_np.shape
    n_padded = plan_store_layout(n_valid)
    if width < n_valid:
        raise ValueError("JAX store is narrower than its row count")
    words = np.zeros((wf, n_padded), np.uint32)
    keep = min(width, n_padded)
    words[:, :keep] = words_np[:, :keep]
    pops = None
    if popcounts_np is not None:
        pops = np.zeros(n_padded, np.int16)
        pops[:keep] = popcounts_np[:keep]
        pops = torch.from_numpy(pops).to(device)
    return DenseStore(
        words=torch.from_numpy(words.view(np.int32)).to(device),
        popcounts=pops,
        n_valid=n_valid,
    )


def bitplane_store_from_jax(
    planes_np: np.ndarray,
    popcounts_np: np.ndarray,
    n_valid: int,
    n_shards: int,
    device: torch.device | str = "cpu",
) -> BitplaneStore:
    """Port layout from a JAX bitplane store of any shard count.

    ``planes_np`` is ``uint32 ((bitcount+1)*8, n_shards*M8s)``: row
    ``8p + r``, shard block s holds plane-p words
    ``[s*Ms + r*M8s, s*Ms + (r+1)*M8s)`` with ``Ms = 8*M8s``.
    """
    rows, width = planes_np.shape
    if rows % 8 or width % n_shards:
        raise ValueError(f"not a JAX bitplane layout: {planes_np.shape}")
    n_planes, m8s = rows // 8, width // n_shards
    plain = (
        np.asarray(planes_np, dtype=np.uint32)
        .reshape(n_planes, 8, n_shards, m8s)
        .transpose(0, 2, 1, 3)
        .reshape(n_planes, n_shards * 8 * m8s)
    )
    m = plan_bitplane_layout(n_valid) // 32
    if m > plain.shape[1]:
        raise ValueError("JAX store is narrower than its row count")
    # the columns beyond the port's padding are the JAX store's own padding
    planes = plain[:, :m].copy().view(np.int32)
    pops = np.array(popcounts_np[: 32 * m], dtype=np.int16)
    return BitplaneStore(
        planes=torch.from_numpy(planes).to(device),
        popcounts=torch.from_numpy(pops).to(device),
        n_valid=n_valid,
        bitcount=n_planes - 1,
    )


def store_from_fingerprint_data(
    data: FingerprintData, device: torch.device | str = "cpu"
) -> BitplaneStore:
    """The port's own bitplane store of a library."""
    data.validate()
    return build_bitplane_store(data.packed_words(), device)
