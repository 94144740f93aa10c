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
from gpusimilarity_tpu_torch.ops.fold import fold_words
from gpusimilarity_tpu_torch.ops.scan import popcount_rows
from gpusimilarity_tpu_torch.parallel import sharded
from gpusimilarity_tpu_torch.utils import synth as psynth
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
        np.asarray(js.planes), np.asarray(js.popcounts), data.count, n_devices, "cpu"
    )
    own = store_from_fingerprint_data(data, "cpu")
    assert torch.equal(got.planes, own.planes)
    assert torch.equal(got.popcounts, own.popcounts)
    assert (got.n_valid, got.bitcount) == (own.n_valid, own.bitcount) == (10000, 1024)
    assert own.planes.shape == (1025, sharded.plan_bitplane_layout(10000) // 32)


SLAB = 1024  # rows a slab of the streamed build holds in these tests


def _build_streamed(source, n, fold, tmp_path):
    """A bitplane store of the first ``n`` rows of virtual library 5 from one
    kind of source, through the entry point that kind of source takes."""
    words = psynth.VirtualWords(n, 32, seed=5)
    if source == "virtual_on_device":
        return psynth.build_virtual_bitplane_store(n, fold, 32, 5, device="cpu")
    if source == "virtual_words":
        rows = words
    elif source == "numpy":
        rows = words[:]
    elif source == "memmap":
        path = tmp_path / "rows.u32"
        words[:].tofile(path)
        rows = np.memmap(path, dtype=np.uint32, mode="r", shape=(n, 32))
    else:
        rows = torch.from_numpy(words[:].view(np.int32))
    return sharded.build_bitplane_store(rows, "cpu", fold_factor=fold)


@pytest.mark.parametrize("fold", [1, 4])
@pytest.mark.parametrize(
    "source", ["numpy", "memmap", "virtual_words", "tensor", "virtual_on_device"]
)
@pytest.mark.parametrize("n", [SLAB * 3 + 13, SLAB * 2])
def test_streamed_bitplane_build_equals_whole_array_build(
    source, fold, n, tmp_path, monkeypatch
):
    """The store is built slab by slab: planes and popcounts equal one
    transpose of the whole folded array, from every kind of source, at row
    counts on and off a 32-row word; and the transpose is never handed more
    than one slab of rows (the whole library never sits beside its planes)."""
    monkeypatch.setattr(sharded, "_SLAB_ROWS", SLAB)
    monkeypatch.setattr(psynth, "_GEN_ROWS", SLAB)
    handed = []
    transpose = sharded.planes_from_rows

    def counting(rows, n_cols, extra_planes=0):
        handed.append(rows.shape[0])
        return transpose(rows, n_cols, extra_planes)

    monkeypatch.setattr(sharded, "planes_from_rows", counting)
    store = _build_streamed(source, n, fold, tmp_path)
    assert handed == [SLAB] * (n // SLAB) + [n % SLAB] * (n % SLAB > 0)

    folded = torch.from_numpy(
        np.ascontiguousarray(fold_words(psynth.VirtualWords(n, 32, 5)[:], fold)).view(np.int32)
    )
    n_cols = sharded.plan_bitplane_layout(n)
    assert (store.n_valid, store.bitcount) == (n, 1024 // fold)
    assert torch.equal(store.planes, tbp.planes_from_rows(folded, n_cols, extra_planes=1))
    assert torch.equal(store.popcounts[:n], popcount_rows(folded).to(torch.int16))
    assert (store.popcounts[n:] == 0).all() and store.popcounts.shape == (n_cols,)


def test_bitplane_slab_must_start_on_a_plane_word():
    store = sharded.empty_bitplane_store(100, 1024, torch.device("cpu"))
    rows = torch.zeros((8, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="plane word"):
        sharded.fill_bitplane_slab(store, 16, rows)
    with pytest.raises(ValueError, match="width"):
        sharded.fill_bitplane_slab(store, 32, rows[:, :8])
    with pytest.raises(ValueError, match="does not divide"):
        sharded.build_bitplane_store(np.zeros((8, 32), np.uint32), "cpu", fold_factor=5)
