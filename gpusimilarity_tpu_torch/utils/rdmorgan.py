"""RDKit-bit-exact Morgan (ECFP) fingerprints, dependency-free (the port's
copy of ``gpusimilarity_tpu/utils/rdmorgan.py``).

The reference fingerprints everything with RDKit's
``GetMorganFingerprintAsBitVect(mol, radius=2, nBits=1024)``
(the reference's ``python/gpusim_utils.py:55-66``). Round 1 shipped a
*hash-incompatible* builtin fallback plus a provenance guard; this module
removes the incompatibility: it reproduces RDKit's Morgan bits exactly, so a
database built with RDKit can be queried by a host without it (and vice
versa).

Verified against the reference's test fixture ``test/small.fsim``
— 100 real ZINC compounds whose stored fingerprints were generated by RDKit —
all 100 match bit-for-bit (``tests/test_rdmorgan.py``).

What "bit-exact" requires (all reimplemented here from the algorithm's
published definition — Rogers & Hahn ECFP — plus RDKit's documented
semantics; no RDKit code was available or consulted in this environment):

* RDKit hashes with a **vendored 32-bit Boost-style hash** (that is why its
  fingerprints are platform/boost-version independent):
  ``seed ^= v + 0x9e3779b9 + (seed << 6) + (seed >> 2)`` over ``uint32``.
* Initial atom invariants hash the component vector
  ``[atomicNum, totalDegree, totalNumHs, formalCharge, deltaMass, (1 if in
  ring)]``.
* Each iteration re-hashes ``seed = layer`` combined with the previous
  invariant and the sorted ``(bondType, neighborInvariant)`` pairs, where
  ``bondType`` is RDKit's enum (SINGLE=1, DOUBLE=2, TRIPLE=3, AROMATIC=12).
* Environment deduplication: an atom environment is its set of bonds within
  the current radius; per round, environments are sorted by (bond-set as a
  big-endian bitset, invariant, atom index) and only the first occurrence of
  a novel environment sets a bit; an atom whose environment was already seen
  in an earlier round stops growing ("dead").
* Bit index = invariant mod nBits; round-0 invariants always set bits.
"""

from __future__ import annotations

import numpy as np

from .smiles import Molecule

_M32 = 0xFFFFFFFF

# standard atomic weights for elements 1-96 (3+ decimals — enough precision
# for int(mass - weight) parity; values past the organic subset matter only
# for isotope-labeled organometallics/radiopharma)
_ATOMIC_WEIGHTS = {
    1: 1.008, 2: 4.0026, 3: 6.94, 4: 9.0122, 5: 10.811, 6: 12.011,
    7: 14.007, 8: 15.999, 9: 18.998, 10: 20.180, 11: 22.990, 12: 24.305,
    13: 26.982, 14: 28.086, 15: 30.974, 16: 32.067, 17: 35.453, 18: 39.948,
    19: 39.098, 20: 40.078, 21: 44.956, 22: 47.867, 23: 50.942, 24: 51.996,
    25: 54.938, 26: 55.845, 27: 58.933, 28: 58.693, 29: 63.546, 30: 65.38,
    31: 69.723, 32: 72.630, 33: 74.922, 34: 78.971, 35: 79.904, 36: 83.798,
    37: 85.468, 38: 87.62, 39: 88.906, 40: 91.224, 41: 92.906, 42: 95.95,
    43: 97.907, 44: 101.07, 45: 102.906, 46: 106.42, 47: 107.868,
    48: 112.414, 49: 114.818, 50: 118.71, 51: 121.760, 52: 127.60,
    53: 126.904, 54: 131.293, 55: 132.905, 56: 137.327, 57: 138.905,
    58: 140.116, 59: 140.908, 60: 144.242, 61: 144.913, 62: 150.36,
    63: 151.964, 64: 157.25, 65: 158.925, 66: 162.500, 67: 164.930,
    68: 167.259, 69: 168.934, 70: 173.045, 71: 174.967, 72: 178.486,
    73: 180.948, 74: 183.84, 75: 186.207, 76: 190.23, 77: 192.217,
    78: 195.084, 79: 196.967, 80: 200.592, 81: 204.383, 82: 207.2,
    83: 208.980, 84: 208.982, 85: 209.987, 86: 222.018, 87: 223.020,
    88: 226.025, 89: 227.028, 90: 232.038, 91: 231.036, 92: 238.029,
    93: 237.048, 94: 244.064, 95: 243.061, 96: 247.070,
}

# exact masses of the isotopes that occur in chemistry corpora (stable
# heavy labels + the common PET/SPECT/therapy radionuclides); unknown
# (element, isotope) pairs fall back to the mass number itself — that
# approximation is within ~0.1 amu of the true mass, so int(mass - weight)
# is still usually exact, but knife-edge cases belong in this table
_ISOTOPE_MASSES = {
    (1, 1): 1.00783, (1, 2): 2.01410, (1, 3): 3.01605,
    (5, 10): 10.01294, (5, 11): 11.00931,
    (6, 11): 11.01143, (6, 12): 12.0, (6, 13): 13.00335, (6, 14): 14.00324,
    (7, 13): 13.00574, (7, 14): 14.00307, (7, 15): 15.00011,
    (8, 15): 15.00307, (8, 16): 15.99491, (8, 17): 16.99913,
    (8, 18): 17.99916,
    (9, 18): 18.00094, (9, 19): 18.99840,
    (15, 31): 30.97376, (15, 32): 31.97391, (15, 33): 32.97173,
    (16, 32): 31.97207, (16, 33): 32.97146, (16, 34): 33.96787,
    (16, 35): 34.96903, (16, 36): 35.96708,
    (17, 35): 34.96885, (17, 37): 36.96590,
    (27, 57): 56.93629, (27, 60): 59.93382,
    (29, 64): 63.92976,
    (31, 67): 66.92820, (31, 68): 67.92798,
    (35, 76): 75.92454, (35, 79): 78.91834, (35, 81): 80.91629,
    (39, 90): 89.90714,
    (40, 89): 88.90888,
    (43, 99): 98.90625,
    (49, 111): 110.90511,
    (53, 123): 122.90559, (53, 124): 123.90621, (53, 125): 124.90463,
    (53, 127): 126.90447, (53, 131): 130.90613,
    (71, 177): 176.94363,
    (82, 212): 211.99190,
    (85, 211): 210.98750,
    (88, 223): 223.01850,
    (89, 225): 225.02323,
}


def hash_combine(seed: int, value: int) -> int:
    """One step of the 32-bit Boost-style ``hash_combine`` RDKit vendors."""
    return (
        seed
        ^ ((value + 0x9E3779B9 + ((seed << 6) & _M32) + (seed >> 2)) & _M32)
    ) & _M32


def hash_range(values) -> int:
    """``hash_range``: fold ``hash_combine`` over a sequence from seed 0."""
    seed = 0
    for v in values:
        seed = hash_combine(seed, v & _M32)
    return seed


def _hash_pair(a: int, b: int) -> int:
    """Hash of a ``std::pair`` — ``hash_range`` over its two elements."""
    return hash_combine(hash_combine(0, a & _M32), b & _M32)


def _delta_mass(atomic_number: int, isotope: int) -> int:
    """``int(isotopeMass - standardAtomicWeight)``, 0 for unspecified."""
    if not isotope:
        return 0
    mass = _ISOTOPE_MASSES.get((atomic_number, isotope), float(isotope))
    weight = _ATOMIC_WEIGHTS.get(atomic_number, float(isotope))
    return int(mass - weight)  # truncation toward zero, like a C cast


def connectivity_invariant(mol: Molecule, idx: int) -> int:
    """RDKit's default ("connectivity") initial invariant for one atom."""
    a = mol.atoms[idx]
    hs = a.total_hs
    components = [
        a.atomic_number,
        mol.degree(idx) + hs,  # totalDegree: graph neighbors + hydrogens
        hs,  # totalNumHs
        a.charge & _M32,  # formal charge, cast to uint32 like C++
        _delta_mass(a.atomic_number, a.isotope) & _M32,
    ]
    if a.in_ring:
        components.append(1)
    return hash_range(components)


# RDKit Bond::BondType values for the orders this parser produces
_BOND_TYPE = {1: 1, 2: 2, 3: 3, 4: 4}
_AROMATIC_BOND = 12


def morgan_bits(mol: Molecule, radius: int = 2, nbits: int = 1024) -> np.ndarray:
    """0/1 vector (``uint8[nbits]``) of the RDKit-compatible Morgan FP.

    Chirality is ignored (RDKit's default ``useChirality=False``), bond
    types are used (default ``useBondTypes=True``), and redundant
    environments are excluded (default ``includeRedundantEnvironments=
    False``) — the exact configuration the reference uses.
    """
    n = len(mol.atoms)
    bits = np.zeros(nbits, dtype=np.uint8)
    if n == 0:
        return bits

    invariants = [connectivity_invariant(mol, i) for i in range(n)]
    for inv in invariants:  # round 0: every atom sets its bit
        bits[inv % nbits] = 1

    neighborhoods: list[int] = []  # bond-set masks of all novel environments
    atom_nbhd = [0] * n  # per-atom bond-set mask at the current radius
    dead = [False] * n

    for layer in range(radius):
        round_inv = list(invariants)
        round_nbhd = list(atom_nbhd)
        this_round: list[tuple[int, int, int]] = []
        for i in range(n):
            if dead[i]:
                continue
            if mol.degree(i) == 0:
                dead[i] = True
                continue
            nbrs = []
            for bi in mol.neighbors(i):
                b = mol.bonds[bi]
                o = b.other(i)
                round_nbhd[i] |= (1 << bi) | atom_nbhd[o]
                bt = _AROMATIC_BOND if b.aromatic else _BOND_TYPE[b.order]
                nbrs.append((bt, invariants[o]))
            nbrs.sort()
            invar = layer  # the seed starts AT the layer number
            invar = hash_combine(invar, invariants[i])
            for pair in nbrs:
                invar = hash_combine(invar, _hash_pair(*pair))
            round_inv[i] = invar
            this_round.append((round_nbhd[i], invar, i))
            if round_nbhd[i] in neighborhoods:
                # environment already seen at a smaller radius: the atom
                # contributes nothing new from here on
                dead[i] = True
        # emit novel environments in (bitset, invariant, atom) order
        this_round.sort()
        for env, invar, _ in this_round:
            if env not in neighborhoods:
                bits[invar % nbits] = 1
                neighborhoods.append(env)
        invariants = round_inv
        atom_nbhd = round_nbhd
    return bits


def pack_bits(bits: np.ndarray) -> bytes:
    """Pack a 0/1 vector into bytes, bit i -> byte i//8 bit i%8 (the layout
    RDKit's ``BitVectToBinaryText`` emits and ``.fsim`` files store)."""
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()

