"""The ``.fsim`` library format, one for both packages.

The reader, writer and record type live in the jax-free
``gpusimilarity_tpu.utils.fsim``; code built on the port (the server, the
chip smoke script) imports them from here, as it imports the SMILES query
helper from :mod:`gpusimilarity_tpu_torch.serve.server`.
"""

from gpusimilarity_tpu.utils.fsim import FingerprintData, read_fsim, write_fsim

__all__ = ["FingerprintData", "read_fsim", "write_fsim"]
