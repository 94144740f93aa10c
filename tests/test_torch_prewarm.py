"""PyTorch port: the host page-cache prewarm after a library's upload
(``gpusimilarity_tpu_torch/models/fingerprint_db.py``), the twin of the JAX
package's ``TestPrewarm`` (``tests/test_tfsim.py``), plus the 85%-of-RAM
skip, the background prewarm the one-process server starts and the
synchronous one of an engine built directly. Every engine runs on the CPU.
"""

import dataclasses
import logging
import os
import threading

import numpy as np
import pytest
import torch

from gpusimilarity_tpu_torch.models import fingerprint_db
from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.parallel.multihost import needs_host_sharding
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
from gpusimilarity_tpu_torch.utils.strings import mmap_backing
from gpusimilarity_tpu_torch.utils.tfsim import (
    TfsimStreamWriter,
    load_native,
    save_native,
)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(count, dbkey, seed=3):
    rng = np.random.default_rng(seed)
    fps = np.packbits(rng.random((count, 1024)) < 0.1, axis=1, bitorder="little")
    return FingerprintData(
        dbkey=dbkey, bitcount=1024, fingerprints=fps,
        smiles=[f"C{i}".encode() for i in range(count)],
        ids=[f"ID{i}".encode() for i in range(count)],
    )


def _mapped(tmp_path, count, dbkey):
    data = _data(count, dbkey)
    path = tmp_path / f"{dbkey}.tfsim"
    save_native(path, data)
    loaded = load_native(path)
    assert isinstance(loaded.fingerprints, np.memmap)
    return data, loaded, path


def _messages(caplog, text):
    return [r.getMessage() for r in caplog.records if text in r.getMessage()]


# ----------------------------------------------------- the JAX TestPrewarm


def test_folded_mmap_library_prewarms_rescore_pages(tmp_path, caplog):
    """A folded library loaded from a ``.tfsim`` map touches its pages
    after the upload, before the constructor returns (an engine built
    directly prewarms synchronously)."""
    data, loaded, _ = _mapped(tmp_path, 2048, "pw")
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        db = FingerprintDB(loaded, fold_factor=2, device="cpu")
        assert _messages(caplog, "prewarmed")  # logged inside the constructor
    assert db._prewarm_thread is None
    r = db.search(data.packed_words()[5], k=3, dbkey="pw")
    assert r.scores[0] == 1.0


def test_unfolded_or_ram_library_skips_prewarm(caplog):
    data = _data(512, "pw")
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        FingerprintDB(data, fold_factor=2, device="cpu")  # RAM-backed: nothing to warm
        FingerprintDB(data, device="cpu")  # unfolded: no rescore path
    assert not _messages(caplog, "prewarmed")
    assert len(_messages(caplog, "rescore prewarm not needed")) == 2


def test_tfsim_tables_classified_as_mmap_backed(tmp_path):
    """Table construction views the blob, which downcasts ``np.memmap`` to
    ``ndarray``: the base-chain walk still classifies ``.tfsim`` tables as
    mapped (the multi-process string policy and the blob prewarm read it)."""
    data, loaded, _ = _mapped(tmp_path, 64, "m")
    assert mmap_backing(loaded.ids._blob) is not None
    assert needs_host_sharding(loaded.ids) is False
    assert needs_host_sharding(loaded.smiles) is False
    assert needs_host_sharding(data.ids) is True  # RAM-backed tables still shard


def test_prewarm_fires_through_view_downcast(tmp_path, caplog):
    """A view of the mapped file (``np.asarray`` downcasts ``np.memmap`` to
    ``ndarray``) still gets its pages touched: the gate walks the base
    chain."""
    data, loaded, _ = _mapped(tmp_path, 2048, "pwv")
    viewed = np.asarray(loaded.fingerprints)
    assert not isinstance(viewed, np.memmap)  # the downcast under test
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        db = FingerprintDB(dataclasses.replace(loaded, fingerprints=viewed),
                           fold_factor=2, device="cpu")
    assert _messages(caplog, "prewarmed")
    assert db.search(data.packed_words()[5], k=3, dbkey="pwv").scores[0] == 1.0


# ------------------------------------------------------ what the port adds


def test_maps_skipped_above_85_percent_of_ram(tmp_path, caplog, monkeypatch):
    _, loaded, _ = _mapped(tmp_path, 2048, "big")
    maps_bytes = 2048 * 128 + sum(len(f"C{i}") + len(f"ID{i}") for i in range(2048))
    monkeypatch.setattr(fingerprint_db, "host_memory_bytes",
                        lambda: int(maps_bytes / 0.85) - 1)
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        FingerprintDB(loaded, fold_factor=2, device="cpu")
    assert not _messages(caplog, "prewarmed")
    assert _messages(caplog, "exceeds 85% of RAM")
    caplog.clear()
    monkeypatch.setattr(fingerprint_db, "host_memory_bytes",
                        lambda: int(maps_bytes / 0.85) + 1)
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        FingerprintDB(loaded, fold_factor=2, device="cpu")
    assert _messages(caplog, "prewarmed")


def test_what_is_warmed(tmp_path):
    """Full-width rows only when folded; every mapped blob; hardlinked blobs
    (smiles and ids of one file) once; a virtual library's rows never."""
    _, loaded, _ = _mapped(tmp_path, 2048, "w")
    folded = FingerprintDB(loaded, fold_factor=2, device="cpu")
    unfolded = FingerprintDB(loaded, device="cpu")
    fp_map = mmap_backing(loaded.fingerprints)
    assert any(m is fp_map for m in folded._rescore_maps())
    assert len(folded._rescore_maps()) == 3
    assert not any(m is fp_map for m in unfolded._rescore_maps())
    assert len(unfolded._rescore_maps()) == 2  # the two blobs

    path = tmp_path / "virt.tfsim"
    with TfsimStreamWriter(path, dbkey="v", synthetic_seed=4,
                           strided={"smiles": 13, "ids": 13}) as w:
        ids = np.frombuffer(b"".join(b"SYN%010d" % i for i in range(4096)), np.uint8)
        w.append_batch(None, ids.reshape(-1, 13), ids.reshape(-1, 13))
    os.remove(path / "smiles.blob")
    os.link(path / "ids.blob", path / "smiles.blob")  # fold_scale's layout
    virt = FingerprintDB(load_native(path), fold_factor=4, device="cpu",
                         scan_mode="dense")
    [blob] = virt._rescore_maps()
    assert blob.nbytes == 4096 * 13


def test_async_prewarm_serves_while_warming(tmp_path, caplog, monkeypatch):
    """``async_prewarm=True``: the database answers while the prewarm
    thread still runs, and ``join_prewarm`` returns after its log line."""
    data, loaded, _ = _mapped(tmp_path, 2048, "as")
    release = threading.Event()
    started = threading.Event()
    warm = FingerprintDB._prewarm_rescore_pages

    def held(self):
        started.set()
        assert release.wait(60)
        warm(self)

    monkeypatch.setattr(FingerprintDB, "_prewarm_rescore_pages", held)
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        db = FingerprintDB(loaded, fold_factor=2, device="cpu", async_prewarm=True)
        assert started.wait(60)
        assert db._prewarm_thread.is_alive()
        assert db.search(data.packed_words()[7], k=3, dbkey="as").scores[0] == 1.0
        assert not _messages(caplog, "prewarmed")
        release.set()
        db.join_prewarm()
        assert not db._prewarm_thread.is_alive()
        assert _messages(caplog, "prewarmed")


def test_registry_async_prewarm(tmp_path, caplog):
    """The server's registry uploads, reports the prewarm as continuing in
    the background, and joins it; without the flag it warms in ``add``."""
    _, _, path = _mapped(tmp_path, 2048, "reg")
    with caplog.at_level(logging.INFO, logger="tpusimilarity"):
        reg = DatabaseRegistry.from_fsim_files([str(path)], device="cpu",
                                               fold_factor=2, async_prewarm=True)
        reg.get("reg").join_prewarm()
    assert _messages(caplog, "page prewarm continues in background")
    assert _messages(caplog, "prewarmed")
    assert reg.get("reg")._prewarm_thread is not None
    sync = DatabaseRegistry.from_fsim_files([str(path)], device="cpu", fold_factor=2)
    assert sync.get("reg")._prewarm_thread is None


def test_server_logs_its_prewarm(tmp_path):
    """``cli.server`` (one process) warms a folded ``.tfsim`` in the
    background and its prewarm line reaches the server's log."""
    import signal
    import subprocess
    import sys

    from gpusimilarity_tpu_torch.tools.loadtest import free_port

    _, _, path = _mapped(tmp_path, 2048, "srv")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server", str(path),
         "--port", str(free_port()), "--fold", "2", "--cpu_only"],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True, env=env,
    )
    seen = []
    try:
        for line in proc.stderr:
            seen.append(line)
            text = "".join(seen)
            if "ready on" in text and "prewarmed" in text:
                break
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            rc = None
    assert rc == 0  # SIGINT right after the ready line stops the server
    text = "".join(seen)
    assert "page prewarm continues in background" in text
    assert "prewarmed" in text and "ready on" in text, text[-2000:]
