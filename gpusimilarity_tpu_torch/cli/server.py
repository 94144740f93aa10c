"""Run the similarity-search HTTP service on the GPUs (twin of
``gpusimilarity_tpu/cli/server.py``)::

    python -m gpusimilarity_tpu_torch.cli.server db.fsim [more.fsim ...] --port 8080 \
        [--socket_name gpusimilarity] [--http_interface]

The library shards over every visible CUDA card; without one the server
raises, unless ``--cpu_only`` asks for the plain PyTorch path on the host.
Both phase-1 kernels are built (or loaded from their cached builds) before
the server prints ``ready``. A one-process server then warms the host's page
cache for its memory-mapped rescore rows and string blobs in the background,
as the JAX server does by default, and logs ``prewarmed N GiB of rescore
pages in S s`` (or ``rescore prewarm skipped (...)`` / ``rescore prewarm not
needed (...)``); a multi-process job warms before it serves. ``--fold``,
``--gpu_bitcount``, ``--scan_mode`` and ``--popless`` choose the store as in
the JAX server; a library too large for the cards is folded and served
dense. ``--socket_name`` also serves the reference's binary protocol on
``$TMPDIR/<name>``, ``--http_interface`` the debug HTML UI, and
``--search_timeout_s`` bounds each request's wait.

Multi-process serving, one process per host (or several sharing a card)::

    python -m gpusimilarity_tpu_torch.cli.server db.fsim --coordinator host:port \
        --num_processes 2 --process_id {0,1}

Every process loads its span of the library onto its cards; process 0
serves HTTP and the socket and fans each search out to the others
(``parallel/multihost.MultihostController``), which print ``worker <i>:
<name> fed <n> fp bytes`` and ``tpusimilarity worker <i> ready`` and serve
until process 0 shuts down.

The JAX server's other flags have no counterpart here: ``--pallas`` (the
CUDA kernels are the only device path), ``--no_warmup``,
``--warmup_batch``, ``--warmup_ks`` and ``--jax_cache_dir`` (PyTorch
compiles no program per shape, so there is nothing to warm or cache; the
page prewarm above runs as under the JAX server's default) and
``--jax_profiler_port`` (``torch.profiler`` traces in process).
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..serve.batching import DEFAULT_RESULT_TIMEOUT_S

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
                        help="batching window in milliseconds")
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
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    if args.coordinator:
        multihost.initialize(args.coordinator, args.num_processes, args.process_id)

    mesh = make_mesh(["cpu"] if args.cpu_only else None)
    if not args.cpu_only:
        from ..utils import kernels

        # the kernels the searches launch; the probe's matrix-product
        # kernel serves no request
        for name, build in kernels.load_all(SERVING_KERNELS).items():
            logging.getLogger("tpusimilarity").info(
                "%s kernel ready (%s, built in %.1fs)", name, build.path.name,
                build.seconds,
            )

    from ..models.registry import DatabaseRegistry
    from ..serve.server import SimilarityServer

    registry = DatabaseRegistry.from_fsim_files(
        args.dbnames, mesh=mesh, device_bitcount=args.device_bitcount,
        fold_factor=args.fold, scan_mode=args.scan_mode, popless=args.popless,
        async_prewarm=mesh.n_processes == 1,
    )
    # multi-process: process 0 serves and fans each request out through the
    # controller; the others execute the broadcast requests in a loop
    controller = None
    if mesh.n_processes > 1:
        controller = multihost.MultihostController(
            registry, max_batch=args.max_batch
        )
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
    print(
        f"tpusimilarity ready on {args.hostname}:{server.port} "
        f"({', '.join(registry.names())}; {mesh.n_shards} shards, "
        f"{mesh.n_processes} processes; {devices})",
        file=sys.stderr, flush=True,
    )
    try:
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
