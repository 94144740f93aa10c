"""Measure the instruction rates that bound the phase-1 kernels and that the
card's data sheet does not give::

    python -m gpusimilarity_tpu_torch.tools.probe_b1 [--iters N] [--repeats R]

Builds ``csrc/b1_probe.cu`` and times, with CUDA events, loops of
independent register-to-register instructions on every SM: the binary
tensor-core product ``mma.sync.m16n8k256.b1.b1.and.popc`` (what the dense
kernel computes its intersection counts with), ``popc``, ``lop3`` (two make
a carry-save adder, what the bitplane kernel sums planes with),
``mad.lo.s32`` and the correctly rounded ``div.rn.f32``. One JSON line per
instruction: thread-level instructions per second (for the product also
bit operations per second, 2 x 16 x 8 x 256 per warp instruction), with the
card's name and power limit. Needs the card; there is no CPU version of a
rate.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .probe_mxu import time_ms

KINDS = ("mma_b1_and_popc", "popc", "lop3", "mad_lo_s32", "div_rn_f32")
CHAINS = 8  # independent instructions per loop round (csrc/b1_probe.cu)
MMA_BIT_OPS = 2 * 16 * 8 * 256


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def measure(device: torch.device, iters: int = 4096, repeats: int = 5,
            blocks_per_sm: int = 8) -> list[dict]:
    """One record per instruction kind: the median launch's rate."""
    from ..utils import kernels

    lib = kernels.load("b1_probe").lib
    fn = lib.gpusim_b1_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * blocks_per_sm
    out = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    card = card_line()
    records = []
    for what, kind in enumerate(KINDS):
        def run():
            rc = fn(what, iters, blocks, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"b1 probe launch failed: code {rc}")

        run()
        torch.cuda.synchronize(device)
        ms = time_ms(run, device, repeats)
        per_thread = iters * CHAINS
        record = {"instruction": kind, "card": card, "sms": sms, "blocks": blocks,
                  "iters": iters, "ms": round(ms, 4)}
        if what == 0:
            warp_instr = blocks * 8 * per_thread
            record["warp_instr_per_s"] = warp_instr / (ms / 1e3)
            record["bit_ops_per_s"] = warp_instr * MMA_BIT_OPS / (ms / 1e3)
        else:
            record["thread_instr_per_s"] = blocks * 256 * per_thread / (ms / 1e3)
        records.append(record)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--blocks_per_sm", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a card's rates and needs CUDA")
    for record in measure(torch.device("cuda", 0), args.iters, args.repeats,
                          args.blocks_per_sm):
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
