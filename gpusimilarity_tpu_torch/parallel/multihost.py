"""Multi-process serving: process init, per-process spans, host-sharded
string tables and the request fan-out controller (twin of
``gpusimilarity_tpu/parallel/multihost.py``).

One server process per host, or several sharing one card, each serving the
shards of its own devices (:class:`~.mesh.Mesh`). The library is cut into
contiguous row spans in mesh order, so a process's shards cover one
contiguous span (:func:`process_row_span`), and it reads, folds and uploads
only that span. Every process searches its shards, then the processes
exchange their candidates (:func:`gather_shard_candidates`) and each merges
the identical global candidate set, so results are replicated as in the JAX
package's SPMD program. String tables held in RAM are cut to the process's
span (:class:`HostStrings`) and resolved with one collective per batch.

The JAX ``distribute_rows`` has no counterpart: it assembles one global
device array from every process's rows, while here a process's shards *are*
its local data and nothing is assembled.

**The process group is gloo, over host tensors, not NCCL.** The engine
copies candidates to the host before it assembles results anyway, and what
travels is small: B x k values and indices per shard, a request template of
a few KB, and string bytes. NCCL also refuses two ranks on one GPU, so with
NCCL a machine with one card could run only one rank, and a second backend
would be code that no run there can check.

Lockstep: every process must run the same searches and collectives in the
same order. Process 0 broadcasts each request as a fixed-shape template and
executes it with the values as the template carries them (float32 cutoffs,
alpha and beta), workers run no background work, and strings resolve with
one collective per batch, in the same order everywhere. A failed
``initialize``, a process that dies or a shard whose kernel fails raises,
and the request fails: nothing carries on with fewer shards.
"""

from __future__ import annotations

import logging
import threading
from datetime import timedelta

import numpy as np
import torch
from torch import distributed as dist

#: seconds a process waits at ``initialize`` for the others to join
INIT_TIMEOUT_S = 300.0
# a collective's deadline: a worker waits in its broadcast for the next
# request, however long the server idles
_IDLE_TIMEOUT = timedelta(days=365)


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the job (``--coordinator host:port``): process 0 serves the
    rendezvous store there, and every process joins one gloo process group.
    Raises if the others have not joined within ``INIT_TIMEOUT_S``. Call it
    before building a mesh: :func:`~.mesh.make_mesh` then spans every
    process."""
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be host:port, got {coordinator!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
    store = dist.TCPStore(
        host, int(port), num_processes, process_id == 0,
        timedelta(seconds=INIT_TIMEOUT_S),
    )
    dist.init_process_group(
        "gloo", store=store, world_size=num_processes, rank=process_id,
        timeout=_IDLE_TIMEOUT,
    )


def finalize() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_gather_array(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr``, stacked ``(P, *arr.shape)`` in process
    order: one collective. Every process passes the same shape and dtype."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        return arr[None]
    t = torch.from_numpy(arr)
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def all_gather_object(obj) -> list:
    """Every process's picklable ``obj``, in process order: one
    collective."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def process_row_span(mesh, n_padded: int) -> tuple[int, int]:
    """Global row range ``[lo, hi)`` of this process's shards in a padded
    layout of ``n_padded`` rows cut evenly over the mesh's shards."""
    if n_padded % mesh.n_shards:
        raise ValueError(
            f"n_padded={n_padded} is not divisible by {mesh.n_shards} shards"
        )
    per_shard = n_padded // mesh.n_shards
    return (mesh.first_shard * per_shard,
            (mesh.first_shard + len(mesh.devices)) * per_shard)


def gather_shard_candidates(vals, idx, counts, mesh):
    """Every process's per-shard candidates, in mesh order: ``vals`` f32
    and ``idx`` int64 ``(S_local, B, k)`` and ``counts`` int64 ``(S_local,
    B)``, host tensors, become ``(S, B, k)`` and ``(S, B)``. Three
    collectives; every process gets the same result."""
    if mesh.n_processes == 1:
        return vals, idx, counts
    s_max = max(mesh.process_shards)
    out = []
    for t in (vals, idx, counts):
        pad = torch.zeros((s_max - t.shape[0], *t.shape[1:]), dtype=t.dtype)
        every = all_gather_array(torch.cat([t, pad]).numpy())
        out.append(torch.from_numpy(np.concatenate(
            [every[p, :s] for p, s in enumerate(mesh.process_shards)]
        )))
    return tuple(out)


# ------------------------------------------------------------------ strings


def needs_host_sharding(table) -> bool:
    """True if ``table`` holds its bytes in this process's RAM (a plain list
    or a RAM-backed StringTable): at multi-process scale those are cut to
    the process's span. Memory-mapped tables (``.tfsim``) and constant
    tables live in the page cache and stay whole on every process (a lookup
    touches one page)."""
    from ..utils.strings import (
        ConstantStringTable,
        StridedStringTable,
        StringTable,
        mmap_backing,
    )

    if isinstance(table, ConstantStringTable):
        return False
    if isinstance(table, (StringTable, StridedStringTable)):
        # table construction views the blob, which downcasts np.memmap to
        # ndarray: walk the base chain
        return mmap_backing(table._blob) is None
    return True  # plain list[bytes]


def resolve_strings(table: "HostStrings", indices):
    """Cross-process lookup of one table: a collective (see
    :func:`resolve_strings_many`)."""
    return resolve_strings_many([(table, indices)])[0]


def resolve_strings_many(pairs):
    """Cross-process string lookup for many ``(table, indices)`` pairs —
    every query's smiles and ids of a search batch — in one lengths
    all-gather plus one bytes all-gather. Returns one ``list[bytes]`` per
    pair.

    Every process contributes the strings it owns; rows nobody owns
    (padding indices) resolve to ``b""``. Lengths gather first, so the byte
    buffer is sized to the batch's longest string. Every process must call
    it in the same order with the same index counts: search results are
    replicated, so lockstep callers see identical arguments.
    """
    local = [table.get(int(gi)) for table, indices in pairs for gi in indices]
    k = len(local)
    if k == 0:
        # the index lists are replicated: every process skips alike
        return [[] for _ in pairs]
    lens = np.array([-1 if s is None else len(s) for s in local], np.int32)
    all_lens = all_gather_array(lens)  # (P, k)
    max_len = max(1, int(all_lens.max(initial=0)))
    buf = np.zeros((k, max_len), np.uint8)
    for j, s in enumerate(local):
        if s:
            buf[j, :len(s)] = np.frombuffer(s, np.uint8)
    all_buf = all_gather_array(buf)  # (P, k, max_len)
    flat = []
    for j in range(k):
        owners = np.nonzero(all_lens[:, j] >= 0)[0]
        if owners.size == 0:
            flat.append(b"")
            continue
        p = int(owners[0])
        flat.append(all_buf[p, j, :int(all_lens[p, j])].tobytes())
    out, pos = [], 0
    for _, indices in pairs:
        out.append(flat[pos:pos + len(indices)])
        pos += len(indices)
    return out


class HostStrings:
    """A string table cut to this process's global row span. ``get``
    returns None for rows other processes own; :func:`resolve_strings_many`
    resolves those from their owners."""

    def __init__(self, strings, lo: int, hi: int):
        if hi - lo < len(strings):
            raise ValueError(f"span [{lo}, {hi}) smaller than {len(strings)} strings")
        self._strings = strings
        self.lo = lo
        self.hi = hi

    def __len__(self) -> int:
        return len(self._strings)

    def owns(self, global_index: int) -> bool:
        return self.lo <= global_index < self.lo + len(self._strings)

    def get(self, global_index: int):
        if not self.owns(global_index):
            return None
        return self._strings[global_index - self.lo]

    def __getitem__(self, global_index: int):
        s = self.get(int(global_index))
        if s is None:
            raise IndexError(
                f"row {global_index} is owned by another process (span "
                f"[{self.lo}, {self.lo + len(self._strings)})); use "
                "resolve_strings for cross-process lookups"
            )
        return s


# --------------------------------------------------------------- controller

_OP_SHUTDOWN = 0
_OP_SEARCH = 1
_SIM_CODES = {"tanimoto": 0, "tversky": 1}
_SIM_NAMES = {v: k for k, v in _SIM_CODES.items()}


class MultihostController:
    """Fan search requests from process 0 out to every process.

    Every process must run the same searches in the same order, so a
    request that reaches process 0's HTTP or socket front end cannot just
    run there. Process 0 broadcasts each request's parameters in a
    fixed-shape template, then every process runs the identical registry
    call; workers loop in :meth:`serve_worker` and drop the results (they
    are replicated, and only process 0 holds the connection). One lock
    around each broadcast and its execution keeps the broadcast order the
    workers' execution order while the batcher runs groups concurrently.
    """

    def __init__(self, registry, max_batch: int = 64):
        self.registry = registry
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._closed = False
        self._names = registry.names()
        # one db slot per registry database: a query can never name more,
        # and every process builds the same registry
        self.max_dbs = max(1, len(self._names))
        widths = {registry.get(n).word_count for n in self._names}
        if len(widths) > 1:
            raise ValueError(
                f"multi-process serving needs one fingerprint width, got {widths}"
            )
        self.word_count = widths.pop() if widths else 32

    def _template(self):
        return {
            "meta": np.zeros(3, np.int32),  # op, b, sim_code
            "db_idx": np.full(self.max_dbs, -1, np.int32),
            "key_ok": np.zeros(self.max_dbs, np.int32),
            "queries": np.zeros((self.max_batch, self.word_count), np.uint32),
            "ks": np.zeros(self.max_batch, np.int32),
            "cutoffs": np.zeros(self.max_batch, np.float32),
            "ab": np.ones(2, np.float32),
        }

    @staticmethod
    def _broadcast(payload):
        """Process 0's ``payload`` on every process: the template's arrays
        packed into one byte buffer, one broadcast (an identity in a
        one-process job)."""
        if process_count() == 1:
            return payload
        flat = torch.from_numpy(np.concatenate(
            [v.reshape(-1).view(np.uint8) for v in payload.values()]
        ))
        dist.broadcast(flat, src=0)
        out, pos, raw = {}, 0, flat.numpy()
        for key, v in payload.items():
            out[key] = raw[pos:pos + v.nbytes].view(v.dtype).reshape(v.shape).copy()
            pos += v.nbytes
        return out

    # ------------------------------------------------------------- process 0

    def dispatch_batch(
        self, dbnames, key_oks, queries, ks, cutoffs, similarity, alpha, beta
    ):
        """Broadcast one search and run it here; returns per-db results."""
        b = len(queries)
        if b > self.max_batch:
            raise ValueError(f"batch {b} exceeds multi-process max {self.max_batch}")
        if len(dbnames) > self.max_dbs:
            raise ValueError(f"{len(dbnames)} databases exceed max {self.max_dbs}")
        req = self._template()
        req["meta"][:] = (_OP_SEARCH, b, _SIM_CODES[similarity])
        for i, name in enumerate(dbnames):
            req["db_idx"][i] = self._names.index(name)
            req["key_ok"][i] = int(key_oks[i])
        req["queries"][:b] = queries
        req["ks"][:b] = ks
        req["cutoffs"][:b] = cutoffs
        req["ab"][:] = (alpha, beta)
        with self._lock:
            if self._closed:
                # a batcher group in flight at shutdown fails fast instead of
                # broadcasting into a collective no worker will join
                raise RuntimeError("multi-process controller is shut down")
            self._broadcast(req)
            # execute with the values as the template carries them (float32
            # cutoffs, alpha and beta), as the workers do: a float64 cutoff
            # could keep a boundary row here that the workers drop, and the
            # string collective's shapes would then differ between processes
            return self.registry._execute_batch(
                dbnames,
                key_oks,
                req["queries"][:b],
                [int(k) for k in req["ks"][:b]],
                [float(c) for c in req["cutoffs"][:b]],
                similarity,
                float(req["ab"][0]),
                float(req["ab"][1]),
            )

    def shutdown(self):
        req = self._template()
        req["meta"][0] = _OP_SHUTDOWN
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._broadcast(req)

    # ------------------------------------------------------------- workers

    def serve_worker(self):
        """A worker process's loop: execute broadcast requests until
        shutdown. A failing request is logged and the loop rejoins the next
        broadcast: process 0 reports the same failure to its client and
        stays up, and a dead worker would leave every later broadcast
        waiting."""
        log = logging.getLogger("tpusimilarity.multihost")
        while True:
            req = self._broadcast(self._template())
            op, b, sim_code = (int(x) for x in req["meta"])
            if op == _OP_SHUTDOWN:
                return
            dbnames = [self._names[int(i)] for i in req["db_idx"] if int(i) >= 0]
            key_oks = [bool(k) for k in req["key_ok"][:len(dbnames)]]
            try:
                self.registry._execute_batch(
                    dbnames,
                    key_oks,
                    req["queries"][:b],
                    [int(k) for k in req["ks"][:b]],
                    [float(c) for c in req["cutoffs"][:b]],
                    _SIM_NAMES[sim_code],
                    float(req["ab"][0]),
                    float(req["ab"][1]),
                )
            except Exception:
                log.exception(
                    "multi-process worker: request failed (batch=%d dbs=%s); "
                    "continuing to serve", b, dbnames,
                )
