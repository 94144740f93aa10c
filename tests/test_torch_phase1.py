"""PyTorch port: phase 1 of the bitplane scan against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as the JAX package's own tests run
it (``tests/test_pallas.py``). Single shard, 65,536 columns (m8s 256):
there the JAX colmax ``(B, 8, m8s)`` reshaped to ``(B, -1)`` is in plain
word order, the port's layout, and must match bit for bit.

``test_kernel_matches_plain_on_cuda`` holds the CUDA kernel against the
plain version; it needs a card and skips elsewhere. The module imports JAX
only inside the JAX comparison, so on a machine with a card and no JAX the
CUDA tests run alone with::

    python -m pytest --noconftest -m cuda tests/test_torch_phase1.py
"""

from pathlib import Path

import numpy as np
import pytest

import torch

from gpusimilarity_tpu_torch.ops import bitplane_phase1 as ph1
from gpusimilarity_tpu_torch.ops.bitplane import (
    build_bitplanes_np,
    query_plane_indices,
)
from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np

M8S, N_PAD, N_VALID = 256, 65536, 60000

# (similarity, alpha/beta, cutoffs, query rows (-1 = zero query), bucket)
CASES = {
    # cutoff 0 takes the JAX kernel's integer running-max branch, > 0 its
    # per-column division branch; both in one launch
    "tanimoto_both_branches": ("tanimoto", (1.0, 1.0), (0.0, 0.2, 0.1), (3, 11, -1), None),
    "tversky": ("tversky", (0.7, 0.3), (0.0, 0.3, 0.1), (3, 11, -1), None),
    "bucket256": ("tanimoto", (1.0, 1.0), (0.35,), (5,), 256),
}


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(0xB17)
    words = np.zeros((N_PAD, 32), np.uint32)
    bits = rng.random((N_VALID, 1024)) < 0.05
    words[:N_VALID] = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    planes = build_bitplanes_np(words.view(np.uint8), N_PAD)
    planes = np.concatenate([planes, np.zeros((1, planes.shape[1]), np.uint32)])
    pops = popcount_rows_np(words).astype(np.int32)
    return words, planes, pops


def _inputs(library, case):
    words, _planes, _pops = library
    similarity, ab, cutoffs, rows, bucket = CASES[case]
    q = np.stack([words[r] if r >= 0 else np.zeros(32, np.uint32) for r in rows])
    return similarity, np.asarray(ab, np.float32), np.asarray(cutoffs, np.float32), q, bucket


def _port(library, case, device="cpu"):
    _words, planes, pops = library
    similarity, ab, cutoffs, q, bucket = _inputs(library, case)
    plane_idx, _ = query_plane_indices(q, 1024, bucket)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return similarity, (
        t(planes.view(np.int32)), t(pops.astype(np.int16)), t(plane_idx),
        t(popcount_rows_np(q)), t(cutoffs), t(ab),
    )


def _tversky_colmax_np(words, pops, q, ab):
    """Per-word Tversky maxima with every f32 op rounded on its own."""
    c = np.stack([
        np.unpackbits((words & qi).view(np.uint8), axis=1).sum(axis=1)
        for qi in q
    ]).astype(np.float32)
    qp = popcount_rows_np(q).astype(np.float32)[:, None]
    dp = pops.astype(np.float32)[None, :]
    denom = ab[0] * (qp - c) + ab[1] * (dp - c) + c
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(denom > 0, c / np.maximum(denom, np.float32(1e-30)), 0)
    s = np.where((c == denom) & (denom > 0), 1, s).astype(np.float32)
    s[:, N_VALID:] = -np.inf
    return s.reshape(len(q), -1, 32).max(axis=-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_phase1_matches_pallas_interpret(library, case):
    import jax.numpy as jnp

    from gpusimilarity_tpu.ops.bitplane import (
        query_plane_indices as jax_plane_indices,
    )
    from gpusimilarity_tpu.ops.pallas_bitplane import (
        build_pops3,
        pallas_bitplane_phase1_batched,
    )
    from gpusimilarity_tpu.ops.scan import scores_np

    words, planes, pops = library
    similarity, ab, cutoffs, q, bucket = _inputs(library, case)
    plane_idx, p = jax_plane_indices(q, 1024, bucket)
    if bucket:
        assert p == bucket
    _bmax, jcnt, jcolmax = pallas_bitplane_phase1_batched(
        jnp.asarray(planes.reshape(1025, 8, M8S).reshape(1025 * 8, M8S)),
        jnp.asarray(build_pops3(pops, 1)), jnp.asarray(plane_idx),
        jnp.asarray(popcount_rows_np(q)), jnp.asarray(cutoffs),
        jnp.asarray(ab), jnp.int32(0),
        mc8=M8S, bw8=8, n_valid=N_VALID, similarity=similarity, interpret=True,
    )
    jcolmax = np.asarray(jcolmax).reshape(len(q), -1)

    similarity, args = _port(library, case)
    launches = ph1.launch_count()
    bmax, cnt, colmax = ph1.bitplane_phase1_batched(*args, N_VALID, similarity)
    assert ph1.launch_count() == launches  # the CPU path never launches
    if similarity == "tanimoto":
        np.testing.assert_array_equal(
            colmax.numpy().view(np.int32), jcolmax.view(np.int32)
        )
    else:
        # XLA contracts the Tversky multiply-add into an FMA (measured: 1-2
        # ulp on ~9% of words); the port rounds each op, as the CUDA kernel
        # does, so it is held bit for bit to a numpy f32 oracle instead
        np.testing.assert_allclose(colmax.numpy(), jcolmax, rtol=1e-6)
        np.testing.assert_array_equal(
            colmax.numpy().view(np.int32),
            _tversky_colmax_np(words, pops, q, ab).view(np.int32),
        )
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    # block maxima: 64 consecutive words per 2048-column block
    np.testing.assert_array_equal(
        bmax.numpy(), colmax.numpy().reshape(len(q), -1, 64).max(axis=-1)
    )
    # padded columns are masked; an all-padding word scores -inf
    assert np.isneginf(colmax.numpy()[:, N_VALID // 32 + 1:]).all()
    if case == "tanimoto_both_branches":
        s = scores_np(words[:N_VALID], q)
        np.testing.assert_array_equal(
            cnt.numpy(), (s >= cutoffs[:, None]).sum(axis=1)
        )
        assert int(cnt[0]) == N_VALID  # cutoff 0 counts every valid column
        assert colmax[2].max().item() == 0.0  # the zero query scores 0


def test_wrapper_validates_inputs(library):
    similarity, args = _port(library, "bucket256")
    bad = list(args)
    bad[1] = bad[1].to(torch.int32)  # pops must be int16
    with pytest.raises(ValueError, match="int16"):
        ph1.bitplane_phase1_batched(*bad, N_VALID, similarity)
    with pytest.raises(ValueError, match="similarity"):
        ph1.bitplane_phase1_batched(*args, N_VALID, "cosine")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph1.bitplane_phase1_kernel(*args, N_VALID, similarity)


def test_build_dir_in_source_tree_else_user_cache(tmp_path, monkeypatch):
    """Kernels build inside the source tree; an installed package (no
    ``pyproject.toml`` beside it) builds under the user's cache directory."""
    from gpusimilarity_tpu_torch.utils import kernels

    src = tmp_path / "src"
    (src / "pkg").mkdir(parents=True)
    (src / "pyproject.toml").write_text("")
    assert kernels.build_dir(src / "pkg") == src / "build" / "gpusim_torch"
    site = tmp_path / "site-packages"
    (site / "pkg").mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert kernels.build_dir(site / "pkg") == tmp_path / "cache" / "gpusim_torch"
    assert kernels.build_dir().parent.parent == Path(ph1.__file__).parents[2]


def test_kernel_digest_covers_included_headers(tmp_path):
    """The name of a build hashes the source and every header it includes by
    a quoted name, through other headers too: editing any of them rebuilds,
    editing a file that is not included does not."""
    from gpusimilarity_tpu_torch.utils import kernels

    (tmp_path / "k.cu").write_text('#include <stdint.h>\n  #  include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#include "a.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n")
    (tmp_path / "other.cuh").write_text("#pragma once\n")
    src = tmp_path / "k.cu"
    assert [f.name for f in kernels.source_files(src)] == ["k.cu", "a.cuh", "b.cuh"]
    digest = kernels.source_digest(src)
    (tmp_path / "other.cuh").write_text("int unrelated;\n")
    assert kernels.source_digest(src) == digest
    (tmp_path / "b.cuh").write_text("#pragma once\nint edited;\n")
    assert kernels.source_digest(src) != digest
    # the two serving kernels share one header of score arithmetic
    for name in ("bitplane_phase1", "dense_phase1"):
        files = kernels.source_files(kernels.CSRC / f"{name}.cu")
        assert [f.name for f in files] == [f"{name}.cu", "phase1_epilogue.cuh"]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_cuda(library, case, cuda_device):
    """The CUDA kernel and the plain version agree bit for bit on the card."""
    similarity, args = _port(library, case, cuda_device)
    before = ph1.launch_count()
    _b, cnt, colmax = ph1.bitplane_phase1_batched(*args, N_VALID, similarity)
    assert ph1.launch_count() == before + 1
    pcolmax, pcnt = ph1.bitplane_phase1_plain(*args, N_VALID, similarity)
    torch.cuda.synchronize()
    assert torch.equal(colmax.view(torch.int32), pcolmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)


# (similarity, alpha/beta, cutoffs cycled over the batch, batch, bucket);
# where the kernel's code forks
FORK_CASES = {
    "mixed_cutoffs_b32": ("tanimoto", (1.0, 1.0), (0.0, 0.04, 1.0, -0.5, 0.35), 32, 64),
    "mixed_cutoffs_b128": ("tanimoto", (1.0, 1.0), (0.0, 0.03, 1.0), 128, 64),
    "tversky_b32": ("tversky", (0.7, 0.3), (0.05, 0.0), 32, 64),
    "b1_positive_cutoff": ("tanimoto", (1.0, 1.0), (0.04,), 1, 64),
    "bucket128_16bit_fields": ("tanimoto", (1.0, 1.0), (0.0, 0.04), 4, 128),
    "bucket512_16bit_fields": ("tanimoto", (1.0, 1.0), (0.0, 0.04), 4, 512),
    "bucket512_tversky": ("tversky", (0.3, 0.7), (0.1,), 3, 512),
    "bucket16_dense_query": ("tanimoto", (1.0, 1.0), (0.1, 0.0), 2, 1024),
}


def _fork_args(library, case, device):
    words, planes, pops = library
    similarity, ab, cuts, b, bucket = FORK_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    rows = rng.permutation(N_VALID)
    q = words[rows[pops[rows] <= 64][:b]].copy()  # every query fits bucket 64
    if bucket == 1024:
        q |= words[rng.integers(0, N_VALID, (8, b))].sum(axis=0, dtype=np.uint32)
    if b > 1:
        q[-1] = 0  # a query with no set bits
    plane_idx, p = query_plane_indices(q, 1024, bucket)
    assert p == bucket

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return similarity, (
        t(planes.view(np.int32)), t(pops.astype(np.int16)), t(plane_idx),
        t(popcount_rows_np(q)), t(np.resize(np.float32(cuts), b)),
        t(np.float32(ab)),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FORK_CASES))
def test_kernel_forks_match_plain_on_cuda(library, case, cuda_device):
    """The CUDA kernel agrees with the plain version bit for bit where its
    code forks: cutoffs 0, positive, 1.0 and negative mixed in one launch,
    Tversky, plane buckets on both sides of the 8-bit count fields, a query
    with no set bits, batches of 1, 32 and 128, ``n_valid`` inside a word."""
    similarity, args = _fork_args(library, case, cuda_device)
    n_valid = N_VALID - 13  # ends inside a word
    _b, cnt, colmax = ph1.bitplane_phase1_batched(*args, n_valid, similarity)
    pcolmax, pcnt = ph1.bitplane_phase1_plain(*args, n_valid, similarity)
    torch.cuda.synchronize()
    assert torch.equal(colmax.view(torch.int32), pcolmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)
    if args[2].shape[0] > 1:
        assert colmax[-1].max().item() == 0.0  # the zero query
