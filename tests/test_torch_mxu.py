"""PyTorch port: phase 1 of the dense scan as a matrix product (kernel 3)
against the JAX Pallas kernel, the port's dense phase 1, and its probe.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_mxu.py`` runs it, in
that file's cases. Block maxima and counts must match bit for bit (Tversky:
rtol 1e-6 against JAX, whose CPU compiler contracts the multiply-add into
an FMA, and bit for bit against a numpy f32 oracle that rounds each op).

``test_kernel_matches_plain_on_cuda`` holds the CUDA kernel against the
plain version; it needs a card and skips elsewhere. On a machine with a
card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_mxu.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2
from gpusimilarity_tpu_torch.ops import mxu_phase1 as ph3
from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
from gpusimilarity_tpu_torch.utils import kernels

REPO = Path(__file__).resolve().parent.parent

# name -> (rows, n_valid, shard offset, queries, density, cutoffs,
#          similarity, alpha/beta, block, mc); tests/test_mxu.py's cases
CASES = {
    "b1": (1024, 1024, 0, 1, 0.1, None, "tanimoto", (1.0, 1.0), 128, 512),
    "b4": (1024, 1024, 0, 4, 0.1, None, "tanimoto", (1.0, 1.0), 128, 512),
    "padding_offset": (1024, 900, 512, 2, 0.1, (0.0, 0.0), "tanimoto", (1.0, 1.0), 128, 512),
    "self_match": (512, 512, 0, 1, 0.3, (1.0,), "tanimoto", (1.0, 1.0), 128, 512),
    "tversky": (1024, 1024, 0, 3, 0.1, (0.0, 0.3, 0.5), "tversky", (0.7, 0.3), 128, 512),
}


def _words(rng, n, density):
    bits = rng.random((n, 1024)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _case(name):
    n, n_valid, offset, b, density, cut, sim, ab, block, mc = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    words = _words(rng, n, density)
    queries = words[:b].copy()
    if cut is None:
        cut = np.linspace(0.0, 0.3, b, dtype=np.float32)
    return dict(words=words, queries=queries, cutoffs=np.float32(cut), sim=sim,
                ab=np.float32(ab), block=block, mc=mc, offset=offset,
                n_valid=n_valid)


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _port_args(c, device="cpu"):
    """The wrapper's arguments up to ``similarity``: the store's int16
    popcounts, qbits from the port's own :func:`query_bits`."""
    planar = np.ascontiguousarray(c["words"].T).view(np.int32)
    return (
        _t(planar, device), _t(popcount_rows_np(c["words"]).astype(np.int16), device),
        ph3.query_bits(_t(c["queries"].view(np.int32), device)),
        _t(popcount_rows_np(c["queries"]), device), _t(c["cutoffs"], device),
        _t(c["ab"], device), c["offset"], c["block"], c["n_valid"], c["sim"],
    )


def _tversky_np(words, q, ab, n_valid, offset):
    """Tversky scores with every f32 op rounded on its own."""
    c = np.stack([
        np.unpackbits((words & qi).view(np.uint8), axis=1).sum(axis=1) for qi in q
    ]).astype(np.float32)
    qp = popcount_rows_np(q).astype(np.float32)[:, None]
    dp = popcount_rows_np(words).astype(np.float32)[None, :]
    denom = ab[0] * (qp - c) + ab[1] * (dp - c) + c
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(denom > 0, c / np.maximum(denom, np.float32(1e-30)), 0)
    s = np.where((c == denom) & (denom > 0), 1, s).astype(np.float32)
    s[:, max(0, n_valid - offset):] = -np.inf
    return s


@pytest.mark.parametrize("int8_mxu", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_phase1_matches_pallas_interpret(name, int8_mxu):
    import jax.numpy as jnp

    from gpusimilarity_tpu.ops.pallas_mxu import mxu_scan_phase1, query_bits_np

    c = _case(name)
    planar = np.ascontiguousarray(c["words"].T)
    pops = popcount_rows_np(c["words"])
    jbmax, jcnt = mxu_scan_phase1(
        jnp.asarray(planar), jnp.asarray(pops),
        jnp.asarray(query_bits_np(c["queries"])),
        jnp.asarray(popcount_rows_np(c["queries"])), jnp.asarray(c["cutoffs"]),
        jnp.asarray(c["ab"]), jnp.int32(c["offset"]), mc=c["mc"], bw=c["block"],
        n_valid=c["n_valid"], similarity=c["sim"], int8_mxu=int8_mxu,
        interpret=True,
    )
    jbmax, jcnt = np.asarray(jbmax), np.asarray(jcnt)

    launches = kernels.launches(ph3.KERNEL)
    bmax, cnt = ph3.mxu_phase1(*_port_args(c))  # one product: binary
    assert kernels.launches(ph3.KERNEL) == launches  # the CPU path never launches
    assert bmax.dtype == torch.float32 and cnt.dtype == torch.int64
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    if c["sim"] == "tanimoto":
        np.testing.assert_array_equal(bmax.numpy().view(np.int32), jbmax.view(np.int32))
    else:
        np.testing.assert_allclose(bmax.numpy(), jbmax, rtol=1e-6)
        ref = _tversky_np(c["words"], c["queries"], c["ab"], c["n_valid"], c["offset"])
        ref = ref.reshape(len(ref), -1, c["block"]).max(axis=-1)
        np.testing.assert_array_equal(bmax.numpy().view(np.int32), ref.view(np.int32))
    if name == "padding_offset":
        # global columns 512 + col >= 900 are padding
        assert int(cnt[0]) == 900 - 512 and np.isneginf(bmax.numpy()[:, 4:]).all()
    if name == "self_match":
        assert bmax.max().item() == 1.0 and int(cnt[0]) >= 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_phase1_matches_dense_phase1(name):
    """The same inputs through the port's dense phase 1 (popcounts of the
    packed words) give the same block maxima and counts: kernels 2 and 3
    serve one store."""
    c = _case(name)
    words, pops, _qb, qpops, cut, ab, offset, block, n_valid, sim = _port_args(c)
    bmax, cnt = ph3.mxu_phase1_plain(words, pops, _qb, qpops, cut, ab, offset,
                                     block, n_valid, sim)
    # the dense phase 1 has no shard offset: valid columns [0, n_valid - offset)
    dbmax, dcnt = ph2.dense_phase1_plain(
        words, pops, _t(c["queries"].view(np.int32)), qpops, cut, ab,
        n_valid - offset, block, sim,
    )
    assert torch.equal(bmax.view(torch.int32), dbmax.view(torch.int32))
    assert torch.equal(cnt, dcnt)


def test_query_bits_matches_numpy():
    from gpusimilarity_tpu.ops.pallas_mxu import query_bits_np

    rng = np.random.default_rng(5)
    q = rng.integers(0, 2**32, (6, 32), dtype=np.uint64).astype(np.uint32)
    q[0] = 0xFFFFFFFF  # every sign bit set
    q[1] = 0
    got = ph3.query_bits(torch.from_numpy(q.view(np.int32)))
    assert got.dtype == torch.int8 and tuple(got.shape) == (6, 1024)
    np.testing.assert_array_equal(got.numpy(), query_bits_np(q))


def test_wrapper_validates_inputs():
    args = list(_port_args(_case("b4")))
    with pytest.raises(ValueError, match="1024-bit rows"):
        ph3.mxu_phase1(args[0][:16], *args[1:])
    for block in (3, 4, 32, 512, 96):
        with pytest.raises(ValueError, match="power of two"):
            ph3.mxu_phase1(*args[:7], block, *args[8:])
    with pytest.raises(ValueError, match="power of two"):
        # 1024 columns: 128 divides, but not a 1000-column prefix
        ph3.mxu_phase1(args[0][:, :1000], args[1][:1000], *args[2:])
    bad = list(args)
    bad[1] = bad[1].to(torch.int32)  # pops must be the store's int16
    with pytest.raises(ValueError, match="int16"):
        ph3.mxu_phase1(*bad)
    bad = list(args)
    bad[2] = bad[2].to(torch.uint8)
    with pytest.raises(ValueError, match="int8"):
        ph3.mxu_phase1(*bad)
    bad = list(args)
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ph3.mxu_phase1(*bad)
    bad = list(args)
    bad[3] = bad[3].to("meta")
    with pytest.raises(ValueError, match="one device"):
        ph3.mxu_phase1(*bad)
    with pytest.raises(ValueError, match="similarity"):
        ph3.mxu_phase1(*args[:9], "cosine")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph3.mxu_phase1_kernel(*args)


def test_probe_cpu_only_prints_one_json_line_per_configuration():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), env.get("PYTHONPATH", "")]
    ).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.tools.probe_mxu",
         "--cpu_only", "--rows", "4096", "--batches", "1,4", "--repeats", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    kinds = [(r["kernel"], r["batch"], r["bound_by"]) for r in lines]
    assert kinds == [
        ("mxu", 1, "bytes"), ("dense", 1, "bytes"),
        ("mxu", 4, "bytes"), ("dense", 4, "bytes"),
        ("bitplane", 1, "bytes"), ("bitplane", 4, "bytes"),
    ]
    for r in lines:
        assert "int8" not in r  # the product is binary: no dtype to choose
        assert r["rows"] == 4096 and r["device"] == "cpu"
        assert r["p50_ms"] > 0 and r["fps_per_chip"] > 0


def test_dense_bound_takes_the_larger_of_bytes_and_b1_operations():
    """Kernel 2's bound: its bytes over the memory rate up to a few hundred
    queries, then its AND-popcount bit operations over the measured rate of
    the binary tensor-core product, named as such."""
    from gpusimilarity_tpu_torch.tools import probe_mxu

    n, wf, block = 1_020_017_664, 8, 256
    ms, by = probe_mxu.dense_bound(n, wf, 32, block)
    moved = n * (wf * 4 + 2) + 32 * (wf * 4 + 12) + 32 * (n // block) * 4 + 32 * 8
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    ops = 2.0 * 32 * 256 * n
    assert ops / probe_mxu.PEAK_OPS_PER_S["b1"] * 1e3 < ms
    ms, by = probe_mxu.dense_bound(n, wf, 1024, block)
    assert by == "b1 operations"
    assert ms == pytest.approx(2.0 * 1024 * 256 * n / probe_mxu.PEAK_OPS_PER_S["b1"] * 1e3)


@pytest.mark.parametrize("b", [1, 32, 64, 128])
def test_mxu_bound_counts_the_binary_product_and_bytes_win_to_128(b):
    """Kernel 3's bound is restated for the same work done the card's best
    way: its bytes, or 2 * b * 1024 bit operations a column over the measured
    rate of the binary tensor-core product. Bytes win at every batch a launch
    takes; the product would only bound a batch of several hundred."""
    from gpusimilarity_tpu_torch.tools import probe_mxu

    n, block = 113_335_296, 256
    ms, by = probe_mxu.mxu_bound(n, b, block)
    moved = n * 130 + b * (1024 + 12) + b * (n // block) * 4 + b * 8
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    ops_ms = 2.0 * b * 1024 * n / probe_mxu.PEAK_OPS_PER_S["b1"] * 1e3
    assert ops_ms < ms and ops_ms == pytest.approx(0.02526 * b, rel=1e-3)
    # the same bytes and operations as kernel 2 on this store, so one bound
    assert ms == pytest.approx(probe_mxu.dense_bound(n, 32, b, block)[0], rel=1e-3)
    if b == 128:
        assert probe_mxu.mxu_bound(n, 1024, block)[1] == "b1 operations"


# kernel cases on the card: (rows, n_valid, offset, queries, block,
# similarity); tails shorter than a 256-column tile, every block width, one
# and several 16-query tiles (64: four; 100: seven, the last one ragged), a
# batch over the 128 queries of a launch, n_valid off a block boundary with
# a shard offset
CUDA_CASES = {
    "b64_block256": (8192, 8192, 0, 64, 256, "tanimoto"),
    "b100_block64_offset": (4160, 4000, 77, 100, 64, "tanimoto"),
    "b100_block128_tversky": (4096, 3900, 0, 100, 128, "tversky"),
    "b8_block64": (2112, 2035, 0, 8, 64, "tanimoto"),
    "b1_block256": (4096, 4096, 0, 1, 256, "tanimoto"),
    "b5_block64_tail": (1088, 1000, 0, 5, 64, "tanimoto"),
    "b17_block128_tversky": (4096, 4000, 0, 17, 128, "tversky"),
    "b33_block64_offset": (2048, 2000, 100, 33, 64, "tanimoto"),
    "b128_block128": (4096, 4096, 0, 128, 128, "tanimoto"),
    "b200_block64_tail": (2496, 2400, 0, 200, 64, "tanimoto"),
}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("checked", [True, False], ids=["wrapper", "kernel"])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernel_matches_plain_on_cuda(name, checked, cuda_device):
    """The CUDA kernel, through the checked wrapper or called directly, and
    the plain version agree bit for bit on the card, and with the dense
    kernel on the same store."""
    n, n_valid, offset, b, block, sim = CUDA_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    words = _words(rng, n, 0.05)
    queries = np.concatenate([words[:b - 1], np.zeros((1, 32), np.uint32)])
    c = dict(words=words, queries=queries, offset=offset, n_valid=n_valid,
             cutoffs=np.where(np.arange(b) % 2, 0.35, 0.0).astype(np.float32),
             ab=np.float32([0.7, 0.3]), block=block, sim=sim)
    args = _port_args(c, cuda_device)
    before = kernels.launches(ph3.KERNEL)
    bmax, cnt = (ph3.mxu_phase1 if checked else ph3.mxu_phase1_kernel)(*args)
    assert kernels.launches(ph3.KERNEL) == before + -(-b // ph3.MAX_QUERIES)
    pbmax, pcnt = ph3.mxu_phase1_plain(*args)
    dbmax, dcnt = ph2.dense_phase1(
        args[0], args[1], _t(queries.view(np.int32), cuda_device), *args[3:6],
        n_valid - offset, block, sim,
    )
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)
    assert torch.equal(bmax.view(torch.int32), dbmax.view(torch.int32))
    assert torch.equal(cnt, dcnt)
    assert bmax[-1].max().item() == 0.0  # the zero query


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64, 100])
@pytest.mark.parametrize("start", [0, 3], ids=["aligned", "unaligned"])
def test_kernel_on_a_strided_prefix_on_cuda(b, start, cuda_device):
    """A column window of a wider store (row stride over the column count;
    off 16-byte alignment when it starts at column 3) against the plain
    version and the dense kernel, cutoffs at, above and below 0 and at 1."""
    rng = np.random.default_rng(100 * b + start)
    words = _words(rng, 6000, 0.05)
    queries = np.concatenate([words[:b - 1], np.zeros((1, 32), np.uint32)])
    planar = _t(np.ascontiguousarray(words.T).view(np.int32), cuda_device)
    pops = _t(popcount_rows_np(words).astype(np.int16), cuda_device)
    cols = 5120
    window = planar[:, start:start + cols]
    assert window.stride(0) == 6000
    args = (
        window, pops[start:start + cols].contiguous(),
        ph3.query_bits(_t(queries.view(np.int32), cuda_device)),
        _t(popcount_rows_np(queries), cuda_device),
        _t(np.resize(np.float32([0.0, 0.35, 1.0, -0.5]), b), cuda_device),
        _t(np.float32([1.0, 1.0]), cuda_device), 0, 256, cols - 77, "tanimoto",
    )
    bmax, cnt = ph3.mxu_phase1(*args)
    pbmax, pcnt = ph3.mxu_phase1_plain(*args)
    dbmax, dcnt = ph2.dense_phase1(
        args[0], args[1], _t(queries.view(np.int32), cuda_device), *args[3:6],
        cols - 77, 256, "tanimoto",
    )
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)
    assert torch.equal(bmax.view(torch.int32), dbmax.view(torch.int32))
    assert torch.equal(cnt, dcnt)
