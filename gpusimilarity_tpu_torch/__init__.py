"""tpusimilarity on PyTorch and CUDA: the port of ``gpusimilarity_tpu``.

The JAX package beside this one is the reference. This package serves the
same search — exact Tanimoto / Tversky top-k with per-query k and cutoff,
exact >=cutoff counts, unfolded (bit-sliced "bitplane" store) or folded
(dense store, candidates rescored at full width), multi-database merge and
the HTTP/JSON front end — on one NVIDIA Hopper GPU. Its device kernels are
hand-written CUDA C++ under ``csrc/``: phase 1 of the bitplane scan, of the
dense scan, and of the dense scan as a tensor-core matrix product (measured
by ``tools/probe_mxu``, on no serving path); every other step is plain
tensor code. Entry points run on the card unless given ``device="cpu"``.

Module names mirror the JAX package so each counterpart is easy to find.
The package imports ``torch`` and numpy, never ``jax``, and nothing of the
JAX package: the host modules it needs (``.fsim``/``.tfsim`` I/O, string
tables, the SMILES/Morgan front end, the native library's bindings) are its
own copies under ``utils/``.
"""

__version__ = "0.1.0"

from .utils.smiles import canonical_smiles, parse_smiles  # noqa: F401

__all__ = ["canonical_smiles", "parse_smiles", "__version__"]
