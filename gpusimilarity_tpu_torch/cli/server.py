"""Run the similarity-search HTTP service on one GPU (twin of
``gpusimilarity_tpu/cli/server.py``)::

    python -m gpusimilarity_tpu_torch.cli.server db.fsim [more.fsim ...] --port 8080 \
        [--socket_name gpusimilarity] [--http_interface]

The device is the first CUDA card; without one the server raises, unless
``--cpu_only`` asks for the plain PyTorch path on the host. Both phase-1
kernels are built (or loaded from their cached builds) before the server
prints ``ready``. ``--fold``, ``--gpu_bitcount``, ``--scan_mode`` and
``--popless`` choose the store as in the JAX server; a library too large
for the card is folded and served dense. ``--socket_name`` also serves the
reference's binary protocol on ``$TMPDIR/<name>``, ``--http_interface`` the
debug HTML UI, and ``--search_timeout_s`` bounds each request's wait.

The JAX server's other flags have no counterpart here: ``--pallas`` (the
CUDA kernels are the only device path), ``--no_warmup``,
``--warmup_batch``, ``--warmup_ks`` and ``--jax_cache_dir`` (PyTorch
compiles no program per shape, so there is nothing to warm or cache),
``--jax_profiler_port`` (``torch.profiler`` traces in process), and
``--coordinator``, ``--num_processes`` and ``--process_id``, which belong
to the multi-host mode the port does not have yet.
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
        "fingerprint databases onto one GPU and answer similarity searches "
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
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    from ..parallel.mesh import select_device

    device = select_device(cpu_only=args.cpu_only)
    if device.type == "cuda":
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
        args.dbnames, device=device, device_bitcount=args.device_bitcount,
        fold_factor=args.fold, scan_mode=args.scan_mode, popless=args.popless,
    )
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
    print(
        f"tpusimilarity ready on {args.hostname}:{server.port} "
        f"({', '.join(registry.names())}; {device})",
        file=sys.stderr, flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
