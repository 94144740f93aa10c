"""Run the similarity-search HTTP service on one GPU (twin of
``gpusimilarity_tpu/cli/server.py``)::

    python -m gpusimilarity_tpu_torch.cli.server db.fsim [more.fsim ...] --port 8080

The device is the first CUDA card; without one the server raises, unless
``--cpu_only`` asks for the plain PyTorch path on the host. Both phase-1
kernels are built (or loaded from their cached builds) before the server
prints ``ready``. ``--fold``, ``--gpu_bitcount``, ``--scan_mode`` and
``--popless`` choose the store as in the JAX server; a library too large
for the card is folded and served dense.
"""

from __future__ import annotations

import argparse
import logging
import sys


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

        for name, build in kernels.load_all().items():
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
        max_batch=args.max_batch,
        window_ms=args.batch_window_ms,
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
