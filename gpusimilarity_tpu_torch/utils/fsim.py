"""The ``.fsim`` and ``.tfsim`` library formats, one for both packages.

The readers, writers, record type and the synthetic (virtual) library's
host faces live in the jax-free ``gpusimilarity_tpu.utils`` modules; code
built on the port (the server, the chip smoke script) imports them from
here, as it imports the SMILES query helper from
:mod:`gpusimilarity_tpu_torch.serve.server`.
"""

from gpusimilarity_tpu.utils.fsim import FingerprintData, read_fsim, write_fsim
from gpusimilarity_tpu.utils.strings import ConstantStringTable
from gpusimilarity_tpu.utils.synth import VirtualFingerprints
from gpusimilarity_tpu.utils.tfsim import load_any, save_native

__all__ = [
    "ConstantStringTable",
    "FingerprintData",
    "VirtualFingerprints",
    "load_any",
    "read_fsim",
    "save_native",
    "write_fsim",
]
