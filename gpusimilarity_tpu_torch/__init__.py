"""tpusimilarity on PyTorch and CUDA: the port of ``gpusimilarity_tpu``.

The JAX package beside this one is the reference. This package serves the
same main path — the unfolded bit-sliced ("bitplane") exact Tanimoto /
Tversky top-k search with per-query k and cutoff, exact >=cutoff counts,
multi-database merge and the HTTP/JSON front end — on one NVIDIA Hopper
GPU. Its one device kernel, phase 1 of the bitplane scan, is hand-written
CUDA C++ (``csrc/bitplane_phase1.cu``); every other step is plain tensor
code.

Module names mirror the JAX package so each counterpart is easy to find.
The package imports ``torch`` and numpy, never ``jax``; of the JAX package
it imports only the jax-free host modules under ``gpusimilarity_tpu.utils``
(``.fsim``/``.tfsim`` I/O, string tables, the SMILES/Morgan front end).
"""

__version__ = "0.1.0"
