"""Fingerprint front end: SMILES -> (packed fingerprint, canonical SMILES)
(the port's copy of ``gpusimilarity_tpu/utils/fingerprints.py``).

Drop-in equivalent of the reference's ``gpusim_utils.smiles_to_fingerprint_bin``
(``python/gpusim_utils.py:55-66``): RDKit Morgan radius-2 / ``BITCOUNT``-bit
when RDKit is importable, otherwise the built-in SMILES parser + RDKit-
bit-exact Morgan implementation (``smiles.py`` / ``rdmorgan.py``, verified
bit-for-bit against the reference fixture's RDKit-generated fingerprints).
The engine is fingerprint-agnostic either way.
"""

from __future__ import annotations

import numpy as np

# NOTE: the engine requires the bit count to be divisible by 32 (packed words)
BITCOUNT = 1024
RADIUS = 2

try:  # pragma: no cover - exercised only where rdkit exists
    from rdkit import Chem, DataStructs  # type: ignore
    from rdkit.Chem import rdMolDescriptors  # type: ignore

    HAVE_RDKIT = True
except ImportError:
    HAVE_RDKIT = False


class FingerprintError(RuntimeError):
    """Raised when a SMILES cannot be converted to a fingerprint."""


def generator_tag(bitcount: int = BITCOUNT, radius: int = RADIUS) -> str:
    """Provenance tag of the fingerprint generator active in this process.

    Databases record this tag at build time and the server checks it at
    search time, so a DB built by another generator is caught before it
    is searched. The built-in generator (``rdmorgan.py``) reproduces RDKit's Morgan
    bits exactly — verified on the reference fixture — so ``rdkit-*`` and
    ``rdkit-compat-*`` tags are mutually compatible (see
    ``compatible_generators``). The round-1 ``builtin-*`` tag named a
    hash-incompatible generator and stays incompatible with both.
    """
    kind = "rdkit" if HAVE_RDKIT else "rdkit-compat"
    return f"{kind}-morgan-r{radius}-{bitcount}"


def compatible_generators(tag: str) -> frozenset[str]:
    """All generator tags whose bits are interchangeable with ``tag``'s."""
    for a, b in (("rdkit-compat-", "rdkit-"), ("rdkit-", "rdkit-compat-")):
        if tag.startswith(a):
            return frozenset({tag, b + tag[len(a):]})
    return frozenset({tag})


def smiles_to_fingerprint_bin(
    smiles: str,
    trust_smiles: bool = False,
    bitcount: int = BITCOUNT,
    radius: int = RADIUS,
) -> tuple[bytes, bytes]:
    """SMILES -> (packed fingerprint bytes, canonical SMILES bytes).

    Same contract as the reference utility: raises on unparseable input;
    ``trust_smiles`` skips full sanitization where supported.
    """
    if bitcount % 32:
        raise ValueError("bitcount must be a multiple of 32 (packed words)")
    if HAVE_RDKIT:
        mol = Chem.MolFromSmiles(smiles, sanitize=(not trust_smiles))
        if mol is None:
            raise FingerprintError("Bad structure")
        if trust_smiles:
            mol.UpdatePropertyCache()
            Chem.FastFindRings(mol)
        fp = rdMolDescriptors.GetMorganFingerprintAsBitVect(mol, radius, bitcount)
        return (
            DataStructs.BitVectToBinaryText(fp),
            Chem.MolToSmiles(mol).encode("utf-8"),
        )

    from . import native

    if native.available():
        # native/tsn_chem.cpp: byte-exact with the Python stack below
        # (verified over the fixture corpus + fuzz inputs), ~6x faster
        try:
            return native.smiles_fingerprint(smiles, radius, bitcount)
        except ValueError as e:
            raise FingerprintError(f"Bad structure: {e}") from e

    from .rdmorgan import morgan_bits, pack_bits
    from .smiles import SmilesError, parse_smiles, write_smiles

    try:
        mol = parse_smiles(smiles)
        packed = pack_bits(morgan_bits(mol, radius, bitcount))
        # the writer can also reject (e.g. >99 simultaneously open ring
        # closures) — same FingerprintError contract as the native path
        return packed, write_smiles(mol).encode("utf-8")
    except SmilesError as e:
        raise FingerprintError(f"Bad structure: {e}") from e


def fingerprint_bin_to_words(fp_binary: bytes, bitcount: int = BITCOUNT) -> np.ndarray:
    """Packed fingerprint bytes -> ``uint32[bitcount // 32]`` query words."""
    if len(fp_binary) != bitcount // 8:
        raise ValueError(
            f"fingerprint is {len(fp_binary)} bytes, expected {bitcount // 8}"
        )
    return np.frombuffer(fp_binary, dtype=np.uint8).view(np.uint32).copy()


def smiles_to_query_words(
    smiles: str, bitcount: int = BITCOUNT, trust_smiles: bool = False
) -> tuple[np.ndarray, str]:
    """SMILES -> (query words uint32[W], canonical SMILES str)."""
    fp, canon = smiles_to_fingerprint_bin(
        smiles, trust_smiles=trust_smiles, bitcount=bitcount
    )
    return fingerprint_bin_to_words(fp, bitcount), canon.decode("utf-8")


def smiles_to_image_file(smiles: str, path: str) -> None:
    """Render a 2-D depiction PNG (reference ``gpusim_utils.py:69-71``).

    Depiction requires RDKit; the built-in parser has no coordinate
    generation, so this raises a clear error when RDKit is absent.
    """
    if not HAVE_RDKIT:
        raise FingerprintError(
            "molecule depiction requires RDKit, which is not installed"
        )
    from rdkit.Chem import Draw  # type: ignore

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        raise FingerprintError("Bad structure")
    Draw.MolToFile(mol, path)
