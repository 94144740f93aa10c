"""Run the similarity-search HTTP service on the GPUs (twin of
``gpusimilarity_tpu/cli/server.py``)::

    python -m gpusimilarity_tpu_torch.cli.server db.fsim [more.fsim ...] --port 8080 \
        [--socket_name gpusimilarity] [--http_interface]

The library shards over every visible CUDA card; without one the server
raises, unless ``--cpu_only`` asks for the plain PyTorch path on the host.
A server starts in this order:

1. builds and loads at once (:func:`start_up`, the counterpart of the JAX
   server compiling while its libraries stream): on two threads, the two
   phase-1 kernels it launches, each compiled by nvcc at first use or
   loaded from its cached build (``utils/kernels.py``; logs ``<name> kernel
   ready (...)`` when both are), and the native host runtime, compiled from
   ``native/`` at first use the same way or loaded (``utils/native.py``;
   without a compiler it logs one warning and the host work runs in numpy);
   meanwhile each library is loaded and uploaded to the cards (a store
   build that reaches a kernel waits for that kernel's build). A build
   error stops the start-up;
2. warm-up (``--no_warmup`` skips it): every database runs the JAX server's
   warm-up searches, its row 0 and a query per plane bucket that traffic is
   likely to hit, at each k of ``--warmup_ks`` and each batch size 1, 2, 4,
   ... up to ``--warmup_batch`` (at most ``--max_batch``), through the real
   path, and logs ``warmed up <name> (<s>s)``. PyTorch compiles nothing per
   shape, but a first search still pays for the first launch of each kernel
   module, the caching allocator's growth at its shapes and the first pinned
   copies; the warm-up pays them before the ready line;
3. with ``--profiler_port P``, process ``i`` of the job starts a
   :class:`~..serve.profiler.ProfilerListener` on port ``P + i`` (a
   ``GET /capture?duration_ms=D`` there writes a ``torch.profiler`` trace of
   the whole process under ``--profile_dir``, and ``GET /spans`` the
   served path's span records); the listener primes the profiler first, so
   its device tracing starts before the ready line. Off by default, and
   then no port is bound and no profiler started;
4. ``tpusimilarity ready on ...``. A one-process server then warms the
   host's page cache for its memory-mapped rescore rows and string blobs in
   the background, and logs ``prewarmed N GiB of rescore pages in S s`` (or
   ``rescore prewarm skipped (...)`` / ``rescore prewarm not needed
   (...)``); a multi-process job warms before it serves.

``GET /stats`` reports, under ``startup``, the seconds from the process's
start to each start-up step it reached: ``imported`` (the package and torch
imported), ``cuda_ready`` (a CUDA context on every card), ``kernels_loaded``,
``native_loaded``, ``library_loaded``, ``store_built``, ``warmed`` and
``ready`` (a ``--cpu_only`` server has no ``cuda_ready`` and no
``kernels_loaded``). They come in that order, but for the kernels and
the native runtime, which load on threads of their own beside the rest.

SIGINT at any moment after the ready line closes the server and exits 0.
``--fold``, ``--gpu_bitcount``, ``--scan_mode`` and ``--popless`` choose the
store as in the JAX server; a library too large for the cards is folded and
served dense. ``--socket_name`` also serves the reference's binary protocol
on ``$TMPDIR/<name>``, ``--http_interface`` the debug HTML UI, and
``--search_timeout_s`` bounds each request's wait.

Multi-process serving, one process per host (or several sharing a card)::

    python -m gpusimilarity_tpu_torch.cli.server db.fsim --coordinator host:port \
        --num_processes 2 --process_id {0,1}

Every process loads its span of the library onto its cards and runs the
warm-up in lockstep with the others (its searches join collectives);
process 0 serves HTTP and the socket and fans each search out to the others
(``parallel/multihost.MultihostController``), which print ``worker <i>:
<name> fed <n> fp bytes`` and ``tpusimilarity worker <i> ready`` and serve
until process 0 shuts down.

Three flags of the JAX server are refused: ``--pallas`` (the CUDA kernels
are the only device path), ``--jax_cache_dir`` (there is no XLA program to
cache; the kernels' builds are cached under the build dir) and
``--jax_profiler_port``, whose counterpart is ``--profiler_port`` with
``--profile_dir`` (a trace is pulled over HTTP, not by TensorBoard).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from ..serve.batching import DEFAULT_RESULT_TIMEOUT_S
from ..serve.spans import STARTUP

SERVING_KERNELS = ("bitplane_phase1", "dense_phase1")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="tpusimilarity server (PyTorch/CUDA port) — load "
        "fingerprint databases onto the GPUs and answer similarity searches "
        "over HTTP/JSON."
    )
    parser.add_argument("dbnames", nargs="+", help=".fsim files to serve")
    parser.add_argument("--hostname", default="localhost")
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument(
        "--http_interface", action="store_true",
        help="enable the debug HTML UI (not for production exposure)",
    )
    parser.add_argument(
        "--cpu_only", action="store_true",
        help="run the plain PyTorch path on the host CPU instead of the GPU",
    )
    parser.add_argument(
        "--gpu_bitcount", "--device_bitcount", dest="device_bitcount",
        default=0, type=int,
        help="maximum on-device fingerprint bitcount (forces folding)",
    )
    parser.add_argument(
        "--fold", default=None, type=int,
        help="explicit fold factor (default: auto from free device memory)",
    )
    parser.add_argument(
        "--scan_mode", default="auto", choices=("auto", "dense", "bitplane"),
        help="dense packed-word scan, bit-sliced sparse-query scan, or auto "
        "(bitplane unfolded, dense folded)",
    )
    parser.add_argument(
        "--popless", action="store_true",
        help="dense store without the per-column popcount array (the scan "
        "recomputes popcounts from the words it reads): 2 B/row of device "
        "memory back",
    )
    parser.add_argument("--max_batch", default=64, type=int,
                        help="max queries coalesced into one kernel launch")
    parser.add_argument("--batch_window_ms", default=2.0, type=float,
                        help="how long, in milliseconds, the batcher gathers "
                        "requests while a pass is in flight on the card or "
                        "after a pass of several; with none in flight after a "
                        "pass of one, a request's pass starts at once")
    parser.add_argument(
        "--search_timeout_s", default=DEFAULT_RESULT_TIMEOUT_S, type=float,
        help="per-request result deadline in seconds",
    )
    parser.add_argument(
        "--socket_name", default="",
        help="also serve the reference's binary local-socket protocol on "
        "$TMPDIR/<name> (the reference backend used 'gpusimilarity')",
    )
    parser.add_argument(
        "--coordinator", default="",
        help="multi-process mode: host:port of process 0's rendezvous (run "
        "one server per host with --num_processes/--process_id; the library "
        "shards over every process's cards)",
    )
    parser.add_argument("--num_processes", default=1, type=int,
                        help="total processes in the multi-process job")
    parser.add_argument("--process_id", default=0, type=int,
                        help="this process's rank in the multi-process job")
    parser.add_argument(
        "--no_warmup", action="store_true",
        help="skip the warm-up searches at start-up (the first live requests "
        "then pay the first kernel launches and the allocator's growth)",
    )
    parser.add_argument(
        "--warmup_batch", default=8, type=int,
        help="also warm coalesced batches of 2, 4, ... up to this size (at "
        "most --max_batch; the batching layer groups concurrent requests). "
        "1 = single queries only",
    )
    parser.add_argument(
        "--warmup_ks", default="20,128",
        help="comma-separated return_count values the warm-up searches at "
        "(each k picks its candidate fetch width, and with it the shapes of "
        "the selection and the top-k)",
    )
    parser.add_argument(
        "--profiler_port", default=0, type=int,
        help="serve on-demand torch.profiler traces of this process on this "
        "port (process i of a job on port + i): GET /capture?duration_ms=D. "
        "0 (default): off",
    )
    parser.add_argument(
        "--profile_dir", default=os.path.join(tempfile.gettempdir(), "tpusim-traces"),
        help="where --profiler_port writes its traces",
    )
    return parser.parse_args(argv)


def warmup_ks(args) -> tuple[int, ...]:
    """The k values of ``--warmup_ks``, parsed as the JAX server does."""
    return tuple(int(k) for k in str(args.warmup_ks).split(",") if k.strip())


def _build_kernels(log) -> None:
    from ..utils import kernels

    # the kernels the searches launch; the probe's matrix-product kernel
    # serves no request
    for name, build in kernels.load_all(SERVING_KERNELS).items():
        log.info("%s kernel ready (%s, built in %.1fs)", name, build.path.name,
                 build.seconds)


def _open_cards() -> None:
    """A CUDA context on every visible card, here on the thread that loads
    the libraries (which would open them anyway, in the fold decision or
    the first upload), so that their cost is a step of its own."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.mem_get_info(i)


def _marked(step: str, fn, *args):
    """``fn(*args)``, then mark start-up step ``step``."""
    out = fn(*args)
    STARTUP.mark(step)
    return out


def start_up(args):
    """Join the job, build and load at once: the kernels' nvcc runs (none
    with ``--cpu_only``) and the native host runtime on two threads while
    the libraries load and upload here; both joined before it returns, and
    a build's error raised. Returns ``(mesh, registry)``."""
    from ..models.registry import DatabaseRegistry
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh
    from ..utils import native

    if args.coordinator:
        multihost.initialize(args.coordinator, args.num_processes, args.process_id)
    log = logging.getLogger("tpusimilarity")
    mesh = make_mesh(["cpu"] if args.cpu_only else None)
    with ThreadPoolExecutor(2, thread_name_prefix="tpusim-build") as pool:
        builds = [pool.submit(_marked, "native_loaded", native.available)]
        if not args.cpu_only:
            builds.append(pool.submit(_marked, "kernels_loaded", _build_kernels, log))
            _open_cards()
            STARTUP.mark("cuda_ready")
        registry = DatabaseRegistry.from_fsim_files(
            args.dbnames, mesh=mesh, device_bitcount=args.device_bitcount,
            fold_factor=args.fold, scan_mode=args.scan_mode, popless=args.popless,
            async_prewarm=mesh.n_processes == 1,
            on_loaded=lambda: STARTUP.mark("library_loaded"),
        )
        STARTUP.mark("store_built")
        for build in builds:
            build.result()
    log.info("native host runtime: %s", native.origin())
    return mesh, registry


def main(argv=None):
    STARTUP.mark("imported")
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    from ..parallel import multihost

    mesh, registry = start_up(args)
    # multi-process: process 0 serves and fans each request out through the
    # controller; the others execute the broadcast requests in a loop
    controller = None
    if mesh.n_processes > 1:
        controller = multihost.MultihostController(
            registry, max_batch=args.max_batch
        )
    if not args.no_warmup:
        # every process of a job, in lockstep, before it serves
        registry.warmup(ks=warmup_ks(args),
                        max_batch=min(args.warmup_batch, args.max_batch))
        STARTUP.mark("warmed")
    listener = None
    if args.profiler_port:
        from ..serve.profiler import ProfilerListener

        # processes of a job may share a host: each its own port
        listener = ProfilerListener(
            args.hostname, args.profiler_port + mesh.process_index,
            args.profile_dir, cuda=not args.cpu_only,
            process_index=mesh.process_index)
        logging.getLogger("tpusimilarity").info(
            "profiler listening on %s:%d (GET /capture?duration_ms=D; traces "
            "in %s)", args.hostname, listener.port, args.profile_dir)
    try:
        _serve(args, mesh, registry, controller)
    finally:
        if listener is not None:
            listener.close()


def _serve(args, mesh, registry, controller):
    from ..parallel import multihost
    from ..serve.server import SimilarityServer

    if controller is not None:
        for name in registry.names():
            print(f"worker {mesh.process_index}: {name} fed "
                  f"{registry.get(name).loaded_fp_bytes} fp bytes",
                  file=sys.stderr, flush=True)
        if mesh.process_index != 0:
            print(f"tpusimilarity worker {mesh.process_index} ready",
                  file=sys.stderr, flush=True)
            controller.serve_worker()
            multihost.finalize()
            return
        registry.multihost_controller = controller
    server = SimilarityServer(
        registry,
        hostname=args.hostname,
        port=args.port,
        debug_ui=args.http_interface,
        max_batch=args.max_batch,
        window_ms=args.batch_window_ms,
        socket_name=args.socket_name or None,
        search_timeout_s=args.search_timeout_s,
    )
    devices = ", ".join(map(str, mesh.distinct_devices))
    try:
        # inside the try: a SIGINT that lands in the ready line's write still
        # closes the server and exits 0
        STARTUP.mark("ready")
        print(
            f"tpusimilarity ready on {args.hostname}:{server.port} "
            f"({', '.join(registry.names())}; {mesh.n_shards} shards, "
            f"{mesh.n_processes} processes; {devices})",
            file=sys.stderr, flush=True,
        )
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if controller is not None:
            controller.shutdown()
            multihost.finalize()


if __name__ == "__main__":
    main()
