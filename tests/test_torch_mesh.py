"""PyTorch port: the mesh, the sharded store and its search, held against the
JAX package on the CPU.

A mesh of ``["cpu"] * S`` is the torch counterpart of the JAX tests' fake
host devices: S shards whose searches run the plain versions of the kernels.
The sharded engine at S = 1..4 must equal the JAX engine on a mesh of S fake
devices: scores bit for bit, counts exact, dense indices equal (lowest
global index on ties, also across a shard boundary); bitplane results as
score lists plus counts, indices on tie-free queries (a bitplane store may
return either of two equal-score boundary rows).

The module imports JAX only inside the JAX comparisons, so on a machine
with cards and no JAX the ``cuda`` tests run alone with::

    python -m pytest --noconftest -m cuda tests/test_torch_mesh.py
"""

import types

import numpy as np
import pytest
import torch

from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.ops import bitplane_phase1, dense_phase1, mxu_phase1
from gpusimilarity_tpu_torch.ops.scan import scores_np
from gpusimilarity_tpu_torch.ops.topk import merge_topk
from gpusimilarity_tpu_torch.parallel import mesh as pmesh
from gpusimilarity_tpu_torch.parallel import multihost, sharded
from gpusimilarity_tpu_torch.utils import synth
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData

N_ROWS = 5000
QUERY_ROWS = (0, 17, 2600, 4999)
KS, CUTS = [5, 20, 1, 50], [0.0, 0.3, 0.2, 0.1]


def _data(n=N_ROWS, seed=1, density=0.05, dbkey="k"):
    rng = np.random.default_rng(seed)
    bits = rng.random((n, 1024)) < density
    return FingerprintData(
        dbkey=dbkey, bitcount=1024,
        fingerprints=np.packbits(bits, axis=1, bitorder="little"),
        smiles=[f"C{'C' * (i % 7)}N{i}".encode() for i in range(n)],
        ids=[f"TEST{i:08d}".encode() for i in range(n)],
    )


def _jax_data(data):
    from gpusimilarity_tpu.utils.fsim import FingerprintData as JaxData

    return JaxData(dbkey=data.dbkey, bitcount=data.bitcount,
                   fingerprints=data.fingerprints, smiles=data.smiles,
                   ids=data.ids)


def _jax_mesh(s):
    import jax
    from gpusimilarity_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:s])


# ------------------------------------------------------------------- mesh


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FingerprintDB(_data(100))


def test_mesh_layout_and_its_checks():
    m = pmesh.Mesh(["cpu"] * 3, process_index=1, process_shards=(2, 3, 1))
    assert (m.n_shards, m.n_processes, m.first_shard) == (6, 3, 2)
    assert m.distinct_devices == (torch.device("cpu"),)
    assert multihost.process_row_span(m, 600) == (200, 500)
    with pytest.raises(ValueError, match="has 3 shards"):
        pmesh.Mesh(["cpu"] * 3, process_index=0, process_shards=(2, 3))
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_row_span(m, 601)
    one = pmesh.resolve_mesh(device="cpu")
    assert one.devices == (torch.device("cpu"),) and one.n_shards == 1
    with pytest.raises(ValueError, match="not both"):
        pmesh.resolve_mesh(one, "cpu")


class _FakeJaxDevice:
    def __init__(self, process_index, free):
        self.process_index = process_index
        self._free = free

    def memory_stats(self):
        return {"bytes_limit": self._free, "bytes_in_use": 0}


# (local cards' free bytes by shard, remote shards, JAX-comparable)
MEMORY_CASES = {
    "one_card": ((70 << 30,), 0),
    "two_cards": ((70 << 30, 60 << 30), 0),
    "two_cards_two_remote": ((70 << 30, 60 << 30), 2),
    "one_card_one_remote": ((50 << 30,), 1),
}


@pytest.mark.parametrize("case", sorted(MEMORY_CASES))
def test_free_memory_and_fold_equal_jax_on_distinct_cards(case, monkeypatch):
    """On a mesh of distinct cards the free memory, the extrapolation to
    other processes' cards and the fold equal the JAX package's."""
    import jax
    from gpusimilarity_tpu.parallel import mesh as jmesh

    frees, n_remote = MEMORY_CASES[case]
    n_local = len(frees)
    devices = [torch.device("cuda", i) for i in range(n_local)]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (frees[torch.device(d).index], 80 << 30))
    cards = (tuple(f"GPU-{i}" for i in range(n_local)),
             tuple(f"GPU-r{i}" for i in range(n_remote)))
    mesh = (pmesh.Mesh(devices, 0, (n_local, n_remote), cards) if n_remote
            else pmesh.Mesh(devices))
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    jdevs = [_FakeJaxDevice(0, f) for f in frees] + [
        _FakeJaxDevice(1, 0) for _ in range(n_remote)]
    want = jmesh.available_device_memory(jdevs)
    assert pmesh.available_device_memory(mesh) == want
    for db_bytes in (0, 1 << 30, 130_562_236_416, 10 ** 12):
        assert pmesh.auto_fold_factor(db_bytes, mesh) == jmesh.auto_fold_factor(
            db_bytes, jdevs)


def test_free_memory_counts_a_repeated_card_once(monkeypatch):
    """Four shards on one card: that card's free memory once, not four times
    (which would choose too small a fold). Over processes each physical card
    counts once: a card another process shares adds nothing, a card of its
    own is extrapolated from this process's free memory per card."""
    free = 84 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (free, 80 << 30))
    four = pmesh.Mesh([torch.device("cuda", 0)] * 4)
    assert pmesh.available_device_memory(four) == free
    # 130.6 GB at 0.75 x 84 GiB: fold 2 (it would be 1 if the card counted 4x)
    assert pmesh.auto_fold_factor(130_562_236_416, four) == 2
    shared = pmesh.Mesh([torch.device("cuda", 0)] * 2, 0, (2, 2),
                        (("GPU-a",), ("GPU-a",)))
    assert pmesh.available_device_memory(shared) == free
    own = pmesh.Mesh([torch.device("cuda", 0)] * 2, 0, (2, 2),
                     (("GPU-a",), ("GPU-b",)))
    assert pmesh.available_device_memory(own) == 2 * free
    with pytest.raises(ValueError, match="card identities"):
        pmesh.available_device_memory(
            pmesh.Mesh([torch.device("cuda", 0)] * 2, 0, (2, 2)))
    assert pmesh.available_device_memory(pmesh.Mesh(["cpu"] * 2)) is None


@pytest.mark.parametrize("shared", [True, False])
def test_two_processes_on_one_card_count_it_once(shared, monkeypatch):
    """``make_mesh`` in process 0 of a two-process job: the processes
    exchange their card identities, so two processes that share one card
    see that card once and choose fold 2 for a library of 0.75-1.5x its
    usable memory (both would pick fold 1 and overflow it at upload if the
    card counted once per process); on two cards they see twice the memory
    and fold 1."""
    free = 84 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid="GPU-a"))
    other = (1, ("GPU-a",) if shared else ("GPU-b",))
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    monkeypatch.setattr(multihost, "all_gather_object", lambda obj: [obj, other])
    mesh = pmesh.make_mesh()
    assert mesh.process_shards == (1, 1) and mesh.n_shards == 2
    assert mesh.process_cards == (("GPU-a",), other[1])
    assert pmesh.available_device_memory(mesh) == (1 if shared else 2) * free
    assert pmesh.auto_fold_factor(80_000_000_000, mesh) == (2 if shared else 1)


# ------------------------------------------------------------ shard layout


@pytest.mark.parametrize("n", [1, 255, 256, 5000, 70001, 1 << 20])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_plan_shard_spans_equal_jax_layouts(n, n_shards):
    """The spans are the JAX dense layout at 128-row alignment and the JAX
    bitplane layout at 8192; every process derives them alone."""
    from gpusimilarity_tpu.parallel import sharded as jsharded

    for align, (per, n_padded) in (
        (128, jsharded.plan_store_layout(n, n_shards, 128)[::2]),
        (8192, (jsharded.plan_bitplane_layout(n, n_shards, 8192, False)[1]
                // n_shards,
                jsharded.plan_bitplane_layout(n, n_shards, 8192, False)[1])),
    ):
        spans = sharded.plan_shard_spans(n, n_shards, align)
        assert sharded.shard_rows(n, n_shards, align) == per
        assert per * n_shards == n_padded
        assert [lo for lo, _ in spans] == list(range(0, n_padded, per))
        assert sum(hi - lo for lo, hi in spans) == n
        assert all(hi - lo <= per for lo, hi in spans)


@pytest.mark.parametrize("seed", range(6))
def test_merge_topk_equals_jax_with_ties(seed):
    """Per-shard lists with many equal scores (values from a set of 4) merge
    to the JAX ``merge_topk``'s values and indices exactly."""
    import jax.numpy as jnp
    from gpusimilarity_tpu.ops.topk import merge_topk as jmerge

    rng = np.random.default_rng(seed)
    b, s, k = 3, 1 + seed % 4, 7
    vals = rng.choice(np.float32([0.25, 0.5, 1.0, -np.inf]), (b, s, k))
    vals = -np.sort(-vals, axis=-1)
    idx = (np.arange(s)[None, :, None] * 1000
           + np.sort(rng.choice(1000, (b, s, k)), axis=-1)).astype(np.int64)
    got_v, got_i = merge_topk(torch.from_numpy(vals), torch.from_numpy(idx), k)
    want_v, want_i = jmerge(jnp.asarray(vals), jnp.asarray(idx.astype(np.int32)), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# ---------------------------------------------------------- sharded engine


@pytest.fixture(scope="module")
def library():
    return _data()


def _virtual(n=30000):
    return FingerprintData(
        dbkey="k", bitcount=1024,
        fingerprints=synth.VirtualFingerprints(n, 1024, seed=9),
        smiles=[b"C"] * n, ids=[f"V{i}".encode() for i in range(n)],
    )


# name -> (scan_mode, fold, popless, virtual)
ENGINE_CONFIGS = {
    "dense": ("dense", 1, False, False),
    "fold4": ("dense", 4, False, False),
    "popless": ("dense", 1, True, False),
    "bitplane": ("bitplane", 1, False, False),
    "virtual_fold2": ("dense", 2, False, True),
}


def _tie_free(scores, k):
    """True when the top k of one query's full scan and the next score are
    all distinct: then the indices are determined."""
    top = np.sort(scores)[::-1][:k + 1]
    return len(set(top.tolist())) == len(top)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("config", sorted(ENGINE_CONFIGS))
def test_sharded_engine_equals_jax(library, config, n_shards):
    from gpusimilarity_tpu.models import FingerprintDB as JaxDB

    mode, fold, popless, virtual = ENGINE_CONFIGS[config]
    data = _virtual() if virtual else library
    jdata = data if virtual else _jax_data(data)
    if virtual:
        from gpusimilarity_tpu.utils import synth as jsynth
        from gpusimilarity_tpu.utils.fsim import FingerprintData as JaxData

        jdata = JaxData(dbkey="k", bitcount=1024,
                        fingerprints=jsynth.VirtualFingerprints(30000, 1024, seed=9),
                        smiles=data.smiles, ids=data.ids)
    rows = np.array([0, 17, 2600, data.count - 1])
    q = np.asarray(data.packed_words()[rows])
    db = FingerprintDB(data, mesh=pmesh.make_mesh(["cpu"] * n_shards),
                       scan_mode=mode, fold_factor=fold, popless=popless)
    assert db.store.n_shards == n_shards == len(db.store.shards)
    jdb = JaxDB(jdata, mesh=_jax_mesh(n_shards), scan_mode=mode,
                fold_factor=fold, popless=popless)
    got = db.search_batch(q, KS, CUTS, "k", return_indices=True)
    want = jdb.search_batch(q, KS, CUTS, "k", return_indices=True)
    full = scores_np(np.asarray(data.packed_words()[:]), q) if not virtual else None
    for qi, (g, w) in enumerate(zip(got, want)):
        assert g.approximate_count == w.approximate_count
        assert g.scores == w.scores  # Tanimoto: bit for bit
        assert g.scores[0] == 1.0 and g.indices[0] == rows[qi]
        if mode == "dense" or _tie_free(full[qi], KS[qi]):
            assert (g.indices, g.ids, g.smiles) == (w.indices, w.ids, w.smiles)
        else:
            assert [full[qi][i] for i in g.indices] == g.scores


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_dense_ties_across_a_shard_boundary_go_to_the_lowest_index(n_shards):
    """Copies of the query row on both sides of every shard boundary: the
    top k lists them in global index order, as the JAX engine does."""
    from gpusimilarity_tpu.models import FingerprintDB as JaxDB

    data = _data(4000, seed=3)
    spans = sharded.plan_shard_spans(4000, n_shards, sharded.DENSE_BLOCK_COLS)
    fps = data.fingerprints
    copies = sorted({10} | {r for lo, _ in spans[1:] for r in (lo - 1, lo)})
    for r in copies:
        fps[r] = fps[10]
    q = data.packed_words()[10]
    k = len(copies) - 1  # the last copy falls just outside
    db = FingerprintDB(data, mesh=pmesh.make_mesh(["cpu"] * n_shards),
                       scan_mode="dense")
    got = db.search(q, k=k, dbkey="k", return_indices=True)
    want = JaxDB(_jax_data(data), mesh=_jax_mesh(n_shards), scan_mode="dense").search(
        q, k=k, dbkey="k", return_indices=True)
    assert got.indices == copies[:k] == want.indices
    assert got.scores == [1.0] * k == want.scores


def test_a_shard_of_padding_only_returns_nothing():
    """Four bitplane shards of 2048 rows for 5000 rows: the last holds only
    padding; its search returns -inf / -1 and a count of 0."""
    data = _data()
    db = FingerprintDB(data, mesh=pmesh.make_mesh(["cpu"] * 4), scan_mode="bitplane")
    assert [s.n_valid for s in db.store.shards] == [2048, 2048, 904, 0]
    q = data.packed_words()[[3]]
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np

    plane_idx, _ = query_plane_indices(q, 1024)
    vals, idx, counts = sharded.sharded_local_topk(
        db.store, plane_idx, popcount_rows_np(q), np.float32([-1.0]), 8)
    assert counts[:, 0].tolist() == [2048, 2048, 904, 0]
    assert counts.dtype == torch.int64
    assert idx[0, 0].item() == 3 and vals[0, 0].item() == 1.0
    assert bool((idx >= 0).all())
    # the empty shard alone
    empty = sharded.ShardedStore(
        shards=db.store.shards[3:], row0s=db.store.row0s[3:], n_valid=5000,
        n_shards=1, per_shard=2048, mesh=pmesh.Mesh(["cpu"]))
    v, i, c = sharded.sharded_local_topk(
        empty, plane_idx, popcount_rows_np(q), np.float32([-1.0]), 8)
    assert bool((v == float("-inf")).all()) and bool((i == -1).all())
    assert c.tolist() == [[0]]


class _RecordingRows:
    """Packed rows that record the row ranges a build reads."""

    def __init__(self, rows):
        self._rows = rows
        self.shape = rows.shape
        self.read = []

    def __getitem__(self, key):
        self.read.append((key.start, key.stop))
        return self._rows[key]


@pytest.mark.parametrize("mode", ["dense", "bitplane"])
def test_each_process_reads_only_its_span(library, mode):
    """Process 1 of two, two shards each: the build reads only rows of its
    shards' spans, and the feed reports their full-width bytes."""
    rows = _RecordingRows(library.packed_words())
    mesh = pmesh.Mesh(["cpu"] * 2, process_index=1, process_shards=(2, 2))
    store = sharded.build_sharded_store(rows, mesh, mode)
    spans = sharded.plan_shard_spans(N_ROWS, 4, sharded.shard_align(mode))[2:]
    assert rows.read == spans
    assert store.local_rows == sum(hi - lo for lo, hi in spans)
    assert store.row0s == tuple(lo for lo, _ in spans)


def test_registry_stats_report_the_shard_count(library):
    reg = DatabaseRegistry(mesh=pmesh.make_mesh(["cpu"] * 3))
    reg.add("lib", library, scan_mode="dense")
    stats = reg.stats()
    assert stats["databases"]["lib"]["shards"] == 3
    assert stats["device"] == "cpu" and stats["processes"] == 1
    r = reg.search_databases(["lib"], ["k"], library.packed_words()[7], 3)
    assert r.ids[0] == "TEST00000007"
    assert stats["kernel_launches"].keys() == {"bitplane_phase1", "dense_phase1"}


def test_dryrun_multichip_at_four_cpu_shards(capsys):
    from gpusimilarity_tpu_torch.tools import dryrun_multichip

    dryrun_multichip.main(["--shards", "4", "--cpu_only"])
    out = capsys.readouterr().out
    assert "dryrun_multichip(4) on cpu: OK" in out
    assert "multihost bitplane feed" in out


# ---------------------------------------------------- launch device context


class _FakeCuda:
    """A CPU tensor that reports a CUDA device, for the wrappers' checks."""

    def __init__(self, t, device):
        self._t, self.device = t, device

    def __getattr__(self, name):
        return getattr(self._t, name)

    def __getitem__(self, key):
        return _FakeCuda(self._t[key], self.device)


def _fake_launch_env(monkeypatch, module, n_helpers):
    """Fakes of ``torch.cuda.device``, the stream, CUDA allocation and the
    loaded library; returns the list of devices current at each launch."""
    current, seen = [], []

    class FakeDevice:
        def __init__(self, d):
            self.d = torch.device(d)

        def __enter__(self):
            current.append(self.d)

        def __exit__(self, *exc):
            current.pop()

    def launch(*args):
        seen.append(current[-1] if current else None)
        return 0

    real_empty, real_zeros = torch.empty, torch.zeros

    def on_fake_device(real):
        def alloc(*shape, device=None, **kw):
            t = real(*shape, **kw)
            return _FakeCuda(t, torch.device(device)) if device is not None else t
        return alloc

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", on_fake_device(real_empty))
    monkeypatch.setattr(torch, "zeros", on_fake_device(real_zeros))
    helpers = [lambda *a: 1] * n_helpers
    monkeypatch.setattr(module, "_kernel_fn",
                        lambda: (launch, lambda rc: b"", *helpers))
    return seen


def _on(device, *tensors):
    return [_FakeCuda(t, device) for t in tensors]


LAUNCHES = {
    "bitplane_phase1": (bitplane_phase1, 1, lambda dev: (
        bitplane_phase1.bitplane_phase1_kernel(*_on(
            dev, torch.zeros((33, 64), dtype=torch.int32),
            torch.zeros(2048, dtype=torch.int16),
            torch.zeros((2, 4), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2),
            torch.ones(2)), 2000))),
    "dense_phase1": (dense_phase1, 0, lambda dev: (
        dense_phase1.dense_phase1_kernel(*_on(
            dev, torch.zeros((32, 512), dtype=torch.int32),
            torch.zeros(512, dtype=torch.int16),
            torch.zeros((2, 32), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2),
            torch.ones(2)), 500, 256))),
    "mxu_phase1": (mxu_phase1, 1, lambda dev: (
        mxu_phase1.mxu_phase1_kernel(*_on(
            dev, torch.zeros((32, 512), dtype=torch.int32),
            torch.zeros(512, dtype=torch.int16),
            torch.zeros((130, 1024), dtype=torch.int8),
            torch.zeros(130, dtype=torch.int32), torch.zeros(130),
            torch.ones(2)), 0, 256, 500))),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_every_launch_runs_under_its_tensors_device(name, monkeypatch):
    """Each ctypes launch of ``ops/*_phase1.py`` runs inside
    ``torch.cuda.device(<the tensors' device>)``: the C launchers use the
    thread's current device, and a shard on ``cuda:1`` must not launch
    against ``cuda:0``."""
    module, n_helpers, call = LAUNCHES[name]
    seen = _fake_launch_env(monkeypatch, module, n_helpers)
    before = module.launch_count()
    call(torch.device("cuda", 1))
    assert seen and all(d == torch.device("cuda", 1) for d in seen), seen
    assert module.launch_count() > before


# -------------------------------------------------------------- two cards


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("mode", ["dense", "bitplane"])
def test_two_card_mesh_equals_one_card(mode, cards):
    """A library sharded over two (or four) cards answers exactly as on one
    card."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA cards")
    data = _data(300_000, seed=5)
    q = data.packed_words()[[1, 75_000, 150_000, 225_000, 299_999]]
    one = FingerprintDB(data, device="cuda:0", scan_mode=mode)
    devices = [torch.device("cuda", i) for i in range(cards)]
    two = FingerprintDB(data, mesh=pmesh.make_mesh(devices), scan_mode=mode)
    assert [s.planes.device if mode == "bitplane" else s.words.device
            for s in two.store.shards] == devices
    for k, cut in ((20, 0.0), (128, 0.3)):
        got = two.search_batch(q, k, cut, "k", return_indices=True)
        want = one.search_batch(q, k, cut, "k", return_indices=True)
        for g, w in zip(got, want):
            assert (g.scores, g.approximate_count) == (w.scores, w.approximate_count)
            if mode == "dense":
                assert g.indices == w.indices
