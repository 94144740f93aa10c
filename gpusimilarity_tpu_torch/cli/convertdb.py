"""Convert fingerprint databases between the ``.fsim`` interchange format and
the native memory-mappable ``.tfsim`` directory format (the port's twin of
``gpusimilarity_tpu/cli/convertdb.py``; host only)::

    python -m gpusimilarity_tpu_torch.cli.convertdb library.fsim library.tfsim
"""

from __future__ import annotations

import argparse
import sys

from ..utils.tfsim import load_any


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert between .fsim (reference-compatible, compressed) "
        "and .tfsim (native, memory-mappable) fingerprint databases."
    )
    parser.add_argument("src", help="input .fsim file or .tfsim directory")
    parser.add_argument("dst", help="output path; extension picks the format")
    args = parser.parse_args(argv)
    # summarize from the source load: re-reading (and decompressing) the
    # multi-GB file we just wrote would double the runtime
    data = load_any(args.src)
    if str(args.dst).endswith(".fsim"):
        from ..utils.fsim import write_fsim

        write_fsim(args.dst, data)
    else:
        from ..utils.tfsim import save_native

        save_native(args.dst, data)
    print(
        f"Wrote {args.dst}: {data.count} compounds, {data.bitcount} bits, "
        f"dbkey={data.dbkey!r}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
