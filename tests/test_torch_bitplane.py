"""PyTorch port: bitplane host helpers, device transpose, carry-save
counters and conversion of JAX stores, on the CPU."""

import numpy as np
import pytest

import jax
import torch

from gpusimilarity_tpu.ops import bitplane as jbp
from gpusimilarity_tpu.parallel.mesh import make_mesh
from gpusimilarity_tpu.parallel.sharded import build_bitplane_store as jax_store
from gpusimilarity_tpu_torch.ops import bitplane as tbp
from gpusimilarity_tpu_torch.parallel import sharded
from gpusimilarity_tpu_torch.utils.convert import (
    bitplane_store_from_jax,
    store_from_fingerprint_data,
)

from conftest import random_fingerprint_data


def _packed(rng, n, density=0.1):
    bits = rng.random((n, 1024)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


@pytest.mark.parametrize("bucket", [None, 64, 256])
def test_query_plane_indices_matches_jax(rng, bucket):
    q = np.concatenate([_packed(rng, 3, density=0.04), np.zeros((1, 32), np.uint32)])
    got = tbp.query_plane_indices(q, 1024, bucket)
    want = jbp.query_plane_indices(q, 1024, bucket)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert tbp.plane_bucket_for(200, 1024) == jbp.plane_bucket_for(200, 1024) == 256


@pytest.mark.parametrize("n", [1, 31, 5000, 70000])
def test_device_transpose_matches_numpy(rng, n):
    """The torch transpose (words with bit 31 set included, ragged tail,
    padding columns) equals the JAX package's numpy transpose."""
    words = _packed(rng, n, density=0.3)
    words[0] |= np.uint32(0x80000000)
    n_cols = sharded.plan_bitplane_layout(n)
    want = jbp.build_bitplanes_np(words.view(np.uint8), n_cols)
    got = tbp.planes_from_rows(
        torch.from_numpy(words.view(np.int32)), n_cols, extra_planes=1
    ).numpy()
    np.testing.assert_array_equal(got[:-1].view(np.uint32), want)
    assert (got[-1] == 0).all()
    np.testing.assert_array_equal(
        tbp.build_bitplanes_np(words.view(np.uint8), n_cols), want
    )


@pytest.mark.parametrize("p", [1, 2, 3, 7, 64, 200, 1024])
def test_wallace_counters_full_words(p):
    """Counts from the carry-save tree over full-range words (bit 31 set in
    about half of them) equal a plain per-bit sum and the JAX oracle."""
    rng = np.random.default_rng(p)
    planes = rng.integers(0, 1 << 32, (p, 40), dtype=np.uint64).astype(np.uint32)
    planes[0, 0] = 0xFFFFFFFF
    counters = tbp.wallace_popcount_planes(torch.from_numpy(planes.view(np.int32)))
    got = tbp.counters_to_counts(counters).numpy()
    want = jbp.common_from_planes_np(planes, np.arange(p), 40 * 32)
    np.testing.assert_array_equal(got, want)
    # list input gives the same counts
    listed = tbp.wallace_popcount_planes(
        [torch.from_numpy(r.view(np.int32)) for r in planes]
    )
    np.testing.assert_array_equal(tbp.counters_to_counts(listed).numpy(), want)


def test_shr_is_logical():
    x = torch.tensor([-1, -(2**31), 0x40000000, -2], dtype=torch.int32)
    want = [(int(v) & 0xFFFFFFFF) >> s for v, s in zip(x.tolist(), (1, 31, 2, 0))]
    got = tbp.shr(x, torch.tensor([1, 31, 2, 0])).numpy().view(np.uint32)
    assert got.tolist() == want
    assert tbp.shr(x, 4).numpy().view(np.uint32).tolist() == [
        (int(v) & 0xFFFFFFFF) >> 4 for v in x.tolist()
    ]


@pytest.mark.parametrize("n_devices", [1, 8])
def test_store_from_jax_equals_own_store(rng, n_devices):
    """Undoing the JAX store's sub-row interleave (1 and 8 shards) gives
    the port's own store, bit for bit."""
    data = random_fingerprint_data(rng, count=10000, density=0.05)
    js = jax_store(data.packed_words(), mesh=make_mesh(jax.devices()[:n_devices]))
    got = bitplane_store_from_jax(
        np.asarray(js.planes), np.asarray(js.popcounts), data.count, n_devices
    )
    own = store_from_fingerprint_data(data)
    assert torch.equal(got.planes, own.planes)
    assert torch.equal(got.popcounts, own.popcounts)
    assert (got.n_valid, got.bitcount) == (own.n_valid, own.bitcount) == (10000, 1024)
    assert own.planes.shape == (1025, sharded.plan_bitplane_layout(10000) // 32)
