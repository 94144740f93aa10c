"""A dependency-free SMILES parser and canonical writer (the port's copy of
``gpusimilarity_tpu/utils/smiles.py``: the SMILES path of the server).

The reference delegates all chemistry to RDKit (``gpusim_utils.py:55-66``:
SMILES → sanitized mol → canonical SMILES + Morgan fingerprint). RDKit is not
available in every deployment, so this module provides a self-contained
molecular graph: enough SMILES coverage for the common library corpora
(organic subset, brackets with isotope/charge/H-count/chirality, aromatic
atoms and bonds, branches, ring closures incl. %nn, dots, stereo slashes) plus
implicit-hydrogen perception and a deterministic canonical SMILES writer.

When RDKit *is* importable, the pipeline in ``fingerprints.py`` prefers it for
bit-exact reference parity; this parser is the standalone fallback and the
engine for the built-in Morgan fingerprints in ``morgan.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

# default valences for implicit-H perception (Daylight organic subset rules)
_DEFAULT_VALENCES = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

_ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}
_AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}

_ATOMIC_NUMBERS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57,
    "Pt": 78, "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83, "*": 0,
}


class SmilesError(ValueError):
    """Raised on malformed or unsupported SMILES input."""


@dataclass
class Atom:
    symbol: str  # capitalized element symbol ("C", "Cl", "*")
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    explicit_hs: int | None = None  # None = derive implicit count
    chirality: str = ""  # "@", "@@" — parsed, not interpreted
    index: int = 0
    implicit_hs: int = 0
    in_ring: bool = False
    merged_hs: int = 0  # explicit [H] neighbor atoms folded into this atom

    @property
    def atomic_number(self) -> int:
        return _ATOMIC_NUMBERS.get(self.symbol, 0)

    @property
    def total_hs(self) -> int:
        base = self.explicit_hs if self.explicit_hs is not None else self.implicit_hs
        return base + self.merged_hs


@dataclass
class Bond:
    a1: int
    a2: int
    order: int = 1  # 1/2/3; aromatic bonds carry order 1 + aromatic flag
    aromatic: bool = False
    direction: str = ""  # "/" or "\\" stereo marker as written
    in_ring: bool = False

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1

    @property
    def order_value(self) -> float:
        return 1.5 if self.aromatic else float(self.order)


@dataclass
class Molecule:
    atoms: list[Atom] = field(default_factory=list)
    bonds: list[Bond] = field(default_factory=list)
    _neighbors: list[list[int]] | None = None  # atom idx -> bond indices

    def neighbors(self, idx: int) -> list[int]:
        """Bond indices incident to atom ``idx``."""
        if self._neighbors is None:
            nb: list[list[int]] = [[] for _ in self.atoms]
            for bi, b in enumerate(self.bonds):
                nb[b.a1].append(bi)
                nb[b.a2].append(bi)
            self._neighbors = nb
        return self._neighbors[idx]

    def degree(self, idx: int) -> int:
        return len(self.neighbors(idx))

    def neighbor_atoms(self, idx: int) -> list[int]:
        return [self.bonds[bi].other(idx) for bi in self.neighbors(idx)]


# --------------------------------------------------------------------- parse


def _parse_bracket(s: str, pos: int) -> tuple[Atom, int]:
    """Parse a bracket atom starting after '['; returns (atom, pos_after_])."""
    end = s.find("]", pos)
    if end < 0:
        raise SmilesError("unterminated bracket atom")
    body, i, n = s[pos:end], 0, len(s[pos:end])
    isotope = 0
    while i < n and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        if isotope > 9999:  # no real isotope has 5 digits; bounds the int
            raise SmilesError(f"isotope out of range: [{body}]")
        i += 1
    # element (possibly aromatic lowercase, possibly two letters)
    if i >= n:
        raise SmilesError(f"bracket atom missing element: [{body}]")
    aromatic = False
    if (
        i + 1 < n
        and body[i : i + 2].islower()
        and body[i : i + 2] in _AROMATIC_SYMBOLS
    ):
        symbol, aromatic, i = body[i : i + 2].capitalize(), True, i + 2
    elif i + 1 < n and body[i].isupper() and body[i + 1].islower() and (
        body[i : i + 2] in _ATOMIC_NUMBERS
    ):
        symbol, i = body[i : i + 2], i + 2
    elif body[i].isupper() or body[i] == "*":
        symbol, i = body[i], i + 1
    elif body[i].islower() and body[i] in "bcnops":
        symbol, aromatic, i = body[i].upper(), True, i + 1
    else:
        raise SmilesError(f"bad element in bracket atom: [{body}]")

    chirality = ""
    if i < n and body[i] == "@":
        chirality, i = "@", i + 1
        if i < n and body[i] == "@":
            chirality, i = "@@", i + 1
    hs = 0
    explicit = False
    if i < n and body[i] == "H":
        explicit, hs, i = True, 1, i + 1
        if i < n and body[i].isdigit():
            hs, i = int(body[i]), i + 1
    charge = 0
    while i < n and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        if i < n and body[i].isdigit():
            mag = 0
            while i < n and body[i].isdigit():
                mag = mag * 10 + int(body[i])
                if mag > 99:  # chemically absurd; bounds the int
                    raise SmilesError(f"charge out of range: [{body}]")
                i += 1
            charge += sign * mag
        else:
            charge += sign
    if i < n and body[i] == ":":  # atom-map class: parse and discard
        i += 1
        while i < n and body[i].isdigit():
            i += 1
    if i != n:
        raise SmilesError(f"trailing junk in bracket atom: [{body}]")
    return (
        Atom(
            symbol=symbol,
            aromatic=aromatic,
            charge=charge,
            isotope=isotope,
            explicit_hs=hs if explicit else 0,
            chirality=chirality,
        ),
        end + 1,
    )


_ASCII_WS = " \t\r\n\v\f"  # explicit set: the native parser strips the same


def parse_smiles(smiles: str) -> Molecule:
    """Parse SMILES into a Molecule, perceiving implicit hydrogens and rings."""
    s = smiles.strip(_ASCII_WS)
    if not s:
        raise SmilesError("empty SMILES")
    mol = Molecule()
    stack: list[int] = []
    prev: int | None = None
    pending_order: int | None = None  # explicit bond symbol before next atom
    pending_dir: str = ""  # "/" or "\\" when the bond symbol was directional
    ring_openings: dict[int, tuple[int, int | None, str]] = {}
    i, n = 0, len(s)

    def add_atom(atom: Atom):
        nonlocal prev, pending_order, pending_dir
        atom.index = len(mol.atoms)
        mol.atoms.append(atom)
        if prev is not None:
            _add_bond(mol, prev, atom.index, pending_order, pending_dir)
        prev = atom.index
        pending_order = None
        pending_dir = ""

    def ring_closure(num: int):
        nonlocal pending_order, pending_dir
        if prev is None:
            raise SmilesError("ring closure before any atom")
        if num in ring_openings:
            start, open_order, open_dir = ring_openings.pop(num)
            if (
                pending_order is not None
                and open_order is not None
                and pending_order != open_order
            ):
                raise SmilesError(
                    f"ring closure {num} bond order mismatch"
                )
            order = pending_order if pending_order is not None else open_order
            if start == prev:
                raise SmilesError("ring bond to self")
            if any(
                {b.a1, b.a2} == {start, prev} for b in mol.bonds
            ):
                raise SmilesError("duplicate bond via ring closure")
            _add_bond(mol, start, prev, order, pending_dir or open_dir)
        else:
            ring_openings[num] = (prev, pending_order, pending_dir)
        pending_order = None
        pending_dir = ""

    while i < n:
        c = s[i]
        if c == "[":
            atom, i = _parse_bracket(s, i + 1)
            add_atom(atom)
        elif c.isupper():
            sym = s[i : i + 2] if s[i : i + 2] in ("Cl", "Br") else c
            if sym not in _ORGANIC_SUBSET:
                raise SmilesError(f"element {sym!r} must be bracketed")
            add_atom(Atom(symbol=sym))
            i += len(sym)
        elif c in "bcnops":
            add_atom(Atom(symbol=c.upper(), aromatic=True))
            i += 1
        elif c == "*":
            add_atom(Atom(symbol="*"))
            i += 1
        elif c in "-=#$:/\\":
            pending_order = {"-": 1, "=": 2, "#": 3, "$": 4, ":": -1,
                             "/": 1, "\\": 1}[c]
            if c in "/\\":
                pending_dir = c
            i += 1
        elif c.isdigit():
            ring_closure(int(c))
            i += 1
        elif c == "%":
            if i + 2 >= n or not s[i + 1 : i + 3].isdigit():
                raise SmilesError("bad %nn ring closure")
            ring_closure(int(s[i + 1 : i + 3]))
            i += 3
        elif c == "(":
            if prev is None:
                raise SmilesError("branch before any atom")
            if pending_order is not None:
                raise SmilesError("bond symbol before '('")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("unbalanced parentheses")
            if pending_order is not None:
                raise SmilesError("dangling bond symbol before ')'")
            prev = stack.pop()
            i += 1
        elif c == ".":
            if prev is None:
                raise SmilesError("empty component before '.'")
            if pending_order is not None:
                raise SmilesError("bond symbol before '.'")
            prev = None
            i += 1
        elif c in _ASCII_WS:
            break  # SMILES ends at whitespace (title/ID follows)
        else:
            raise SmilesError(f"unexpected character {c!r} at {i}")

    if ring_openings:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_openings)}")
    if stack:
        raise SmilesError("unclosed branch")
    if not mol.atoms:
        raise SmilesError("no atoms in SMILES")
    if pending_order is not None:
        raise SmilesError("dangling bond symbol at end of SMILES")
    _merge_explicit_hydrogens(mol)
    _perceive(mol)
    return mol


def _add_bond(mol: Molecule, a1: int, a2: int, order: int | None, dir: str = ""):
    aromatic = False
    if order == -1:  # explicit ':' aromatic bond
        aromatic, order = True, 1
    if order is None:
        if mol.atoms[a1].aromatic and mol.atoms[a2].aromatic:
            aromatic, order = True, 1
        else:
            order = 1
    mol.bonds.append(
        Bond(a1=a1, a2=a2, order=order, aromatic=aromatic, direction=dir)
    )


def _merge_explicit_hydrogens(mol: Molecule) -> None:
    """Fold plain ``[H]`` graph atoms into their heavy neighbor's H count
    (RDKit's ``MolFromSmiles`` removes explicit hydrogens the same way;
    isotopic/charged/multivalent hydrogens stay as graph atoms)."""
    drop: set[int] = set()
    for i, a in enumerate(mol.atoms):
        if (
            a.symbol != "H"
            or a.isotope
            or a.charge
            or a.chirality
            or (a.explicit_hs or 0) != 0
            or len(mol.neighbors(i)) != 1
        ):
            continue
        b = mol.bonds[mol.neighbors(i)[0]]
        if b.order != 1 or b.aromatic:
            continue
        o = b.other(i)
        if mol.atoms[o].symbol == "H":
            continue
        drop.add(i)
        mol.atoms[o].merged_hs += 1
    if not drop:
        return
    remap = {}
    atoms = []
    for i, a in enumerate(mol.atoms):
        if i not in drop:
            remap[i] = len(atoms)
            a.index = len(atoms)
            atoms.append(a)
    bonds = []
    for b in mol.bonds:
        if b.a1 in drop or b.a2 in drop:
            continue
        b.a1, b.a2 = remap[b.a1], remap[b.a2]
        bonds.append(b)
    mol.atoms, mol.bonds, mol._neighbors = atoms, bonds, None


def _perceive(mol: Molecule) -> None:
    """Ring membership, directional-ring-bond aromaticity, implicit Hs,
    then Hückel aromaticity perception over Kekulé-written rings."""
    _mark_rings(mol)
    _upgrade_directional_ring_bonds(mol)
    for atom in mol.atoms:
        if atom.explicit_hs is not None:
            continue  # bracket atoms: explicit H count is authoritative
        atom.implicit_hs = _implicit_hs(mol, atom.index, atom.merged_hs)
    _aromatize(mol)


def _implicit_hs(mol: Molecule, idx: int, extra_sigma: int = 0) -> int:
    """Implicit-H count from the written bond orders (aromatic = 1.5).

    RDKit rules: half-integer aromatic sums round up; aromatic atoms take
    implicit Hs only up to the DEFAULT (lowest) valence — thiophene 's'
    gets 0 Hs, not valence-4's 1, while benzene 'c' still gets 1;
    aliphatic atoms step up through the allowed valence list. Also used by
    the writer to decide whether an unbracketed token would re-infer the
    atom's true H count (``extra_sigma`` carries merged [H] neighbors at
    perception time only — a written token has none)."""
    a = mol.atoms[idx]
    valences = _DEFAULT_VALENCES.get(a.symbol)
    if valences is None:  # '*' or unbracketed unknown: no implicit H
        return 0
    sigma = (
        sum(mol.bonds[bi].order_value for bi in mol.neighbors(idx))
        + extra_sigma
    )
    ev = int(sigma + 0.5)
    if a.aromatic:
        return max(0, valences[0] - ev)
    for v in valences:
        if ev <= v:
            return v - ev
    return 0  # hypervalent as written: no implicit H


# -------------------------------------------------------- aromaticity model


_EARLY_ELEMENTS = {"B", "Al"}  # charge flips sign in valence adjustment
_PI_ELEMENTS = {"C", "N", "O", "S", "P", "Se", "Te", "As"}


def _valence_shortfall(mol: Molecule, idx: int) -> int | None:
    """How many bond-order units atom ``idx`` is short of its (charge-
    adjusted) default valence, counting aromatic bonds as written order 1.
    ``None`` for elements without a known valence. Shared by kekulization
    (shortfall >= 1 means the atom needs a double bond) and aromaticity
    perception (a valence-short member of a written-aromatic system holds
    one pi electron)."""
    a = mol.atoms[idx]
    valences = _DEFAULT_VALENCES.get(a.symbol)
    if valences is None:
        return None
    dv = valences[0] + (-a.charge if a.symbol in _EARLY_ELEMENTS else a.charge)
    sigma = (
        sum(mol.bonds[bi].order for bi in mol.neighbors(idx)) + a.total_hs
    )
    return dv - sigma

_DISQUALIFIED = -1  # atom can never sit in an aromatic ring
_INCOMPLETE = -2  # pi partner outside the evaluated ring but in a ring


def _electron_contribution(mol: Molecule, idx: int) -> tuple[int, int | None]:
    """(pi-electron count, pi-partner atom or None) for Hückel counting.

    Mirrors RDKit's default aromaticity model: an atom in a double bond
    donates 1 electron paired with its partner; lone-pair heteroatoms
    donate 2; carbocations donate 0; exocyclic double bonds to non-ring
    atoms donate 0; sp3/sp atoms and exotic elements disqualify the ring
    (``_DISQUALIFIED``)."""
    a = mol.atoms[idx]
    if a.symbol not in _PI_ELEMENTS:
        return _DISQUALIFIED, None
    if any(mol.bonds[bi].aromatic for bi in mol.neighbors(idx)):
        # member of a written-aromatic system (mixed-form input like
        # "c1ccc2c(c1)C=CC=C2"): if it is valence-short it holds one
        # delocalized pi electron there; otherwise fall through to the
        # lone-pair / exocyclic typing below
        shortfall = _valence_shortfall(mol, idx)
        if shortfall is not None and shortfall >= 1:
            return 1, None
    multiple = [
        bi
        for bi in mol.neighbors(idx)
        if not mol.bonds[bi].aromatic and mol.bonds[bi].order >= 2
    ]
    if len(multiple) >= 2 or any(mol.bonds[bi].order >= 3 for bi in multiple):
        return _DISQUALIFIED, None  # cumulated/sp center or triple bond
    if len(multiple) == 1:
        return 1, mol.bonds[multiple[0]].other(idx)
    # no multiple bonds: lone pair or vacancy
    sigma = mol.degree(idx) + a.total_hs
    if a.symbol == "C":
        if a.charge == -1 and sigma <= 3:
            return 2, None
        if a.charge == 1 and sigma <= 3:
            return 0, None
        return _DISQUALIFIED, None  # neutral saturated carbon is sp3
    if a.symbol in ("N", "P", "As"):
        if a.charge == 0 and sigma <= 3:
            return 2, None
        if a.charge == -1 and sigma <= 2:
            return 2, None
        if a.charge == 1 and sigma <= 3:
            return 0, None  # e.g. N-oxide written [n+][O-] pre-kekulized
        return _DISQUALIFIED, None
    if a.symbol in ("O", "S", "Se", "Te"):
        if a.charge == 0 and sigma <= 2:
            return 2, None
        if a.charge == 1 and sigma <= 2:
            return 1, None  # pyrylium-style cation
        return _DISQUALIFIED, None
    return _DISQUALIFIED, None


def _smallest_rings(mol: Molecule) -> list[tuple[frozenset, frozenset]]:
    """One smallest cycle through each ring bond (SSSR-like candidate set):
    (atom-index set, bond-index set) pairs, deduplicated."""
    rings: dict[frozenset, frozenset] = {}
    for bi, b in enumerate(mol.bonds):
        if not b.in_ring:
            continue
        prev: dict[int, tuple[int | None, int | None]] = {b.a1: (None, None)}
        queue = deque([b.a1])
        reached = False
        while queue and not reached:
            v = queue.popleft()
            for nbi in mol.neighbors(v):
                if nbi == bi or not mol.bonds[nbi].in_ring:
                    continue
                u = mol.bonds[nbi].other(v)
                if u in prev:
                    continue
                prev[u] = (v, nbi)
                if u == b.a2:
                    reached = True
                    break
                queue.append(u)
        if not reached:
            continue
        atoms, bonds = set(), {bi}
        v: int | None = b.a2
        while v is not None:
            atoms.add(v)
            v, nbi = prev[v]
            if nbi is not None:
                bonds.add(nbi)
        key = frozenset(bonds)
        rings.setdefault(key, frozenset(atoms))
    return [(a, b) for b, a in rings.items()]


def _aromatize(mol: Molecule) -> None:
    """Perceive aromaticity of Kekulé-written rings (RDKit default model).

    Input written in aromatic form (lowercase) is trusted as-is; this pass
    only promotes rings whose bonds are all written with concrete orders.
    A ring (or a fused union of rings, for cases like naphthalene Kekulé
    forms whose double bonds cross rings, azulene, and biphenylene) becomes
    aromatic when every atom contributes and the pi-electron count is
    4n+2. Kekulé bond orders are preserved alongside the aromatic flags.
    Runs after implicit-H perception — hydrogen counts come from the
    written (Kekulé) valences, exactly as RDKit computes them before its
    own aromatization."""
    candidates = []
    contrib: dict[int, tuple[int, int | None]] = {}
    for atoms, bonds in _smallest_rings(mol):
        if all(mol.bonds[bi].aromatic for bi in bonds):
            continue  # fully written-aromatic: trusted as-is
        for i in atoms:
            if i not in contrib:
                contrib[i] = _electron_contribution(mol, i)
        if any(contrib[i][0] == _DISQUALIFIED for i in atoms):
            continue  # an sp3/sp/exotic member sinks every union too
        candidates.append((atoms, bonds))
    if not candidates:
        return

    def evaluate(atom_set: frozenset) -> int:
        """Electron count, or _INCOMPLETE if a pi partner lies outside the
        set but inside some ring (a larger fused union may resolve it)."""
        total = 0
        for i in atom_set:
            electrons, partner = contrib[i]
            if electrons == 1 and partner is not None:
                if partner in atom_set:
                    total += 1
                elif mol.atoms[partner].in_ring:
                    return _INCOMPLETE
                # exocyclic double bond (e.g. 2-pyridone's C=O): 0 electrons
            else:
                total += electrons
        return total

    def mark(ring_ids: tuple[int, ...]) -> None:
        for ri in ring_ids:
            atoms, bonds = candidates[ri]
            for i in atoms:
                mol.atoms[i].aromatic = True
            for bi in bonds:
                mol.bonds[bi].aromatic = True

    # single rings first, then connected fused unions of increasing size
    aromatic_rings: set[int] = set()
    for ri, (atoms, _) in enumerate(candidates):
        n = evaluate(atoms)
        if n >= 0 and n % 4 == 2:
            mark((ri,))
            aromatic_rings.add(ri)

    # ring adjacency: fused = sharing at least one bond
    n_rings = len(candidates)
    adj: list[set[int]] = [set() for _ in range(n_rings)]
    for i in range(n_rings):
        for j in range(i + 1, n_rings):
            if candidates[i][1] & candidates[j][1]:
                adj[i].add(j)
                adj[j].add(i)

    max_union = 6 if n_rings <= 20 else 2
    frontier = {frozenset({ri}) for ri in range(n_rings)}
    seen = set(frontier)
    for _ in range(1, max_union):
        grown: set[frozenset] = set()
        for group in frontier:
            for ri in group:
                for rj in adj[ri]:
                    g = group | {rj}
                    if g not in seen:
                        seen.add(g)
                        grown.add(g)
        for group in grown:
            if group <= aromatic_rings:
                continue
            atom_union = frozenset().union(
                *(candidates[ri][0] for ri in group)
            )
            n = evaluate(atom_union)
            if n >= 0 and n % 4 == 2:
                mark(tuple(group))
                aromatic_rings |= group
        frontier = grown
        if not frontier:
            break


# ------------------------------------------------------------- kekulization


def kekulize(mol: Molecule) -> None:
    """Assign concrete orders to aromatic bonds and clear aromatic flags.

    The analog of RDKit's ``Chem.Kekulize(mol, clearAromaticFlags=True)``:
    every aromatic atom that is short of its valence receives exactly one
    double bond within the aromatic system (a perfect matching found by
    backtracking); remaining aromatic bonds become single. Bonds that were
    aromatized from Kekulé input keep their written orders. Raises
    ``SmilesError`` when no valid Kekulé structure exists."""
    arom_bonds = [
        bi for bi, b in enumerate(mol.bonds) if b.aromatic and b.order == 1
    ]
    needs: set[int] = set()
    for a in mol.atoms:
        if not a.aromatic:
            continue
        shortfall = _valence_shortfall(mol, a.index)
        if shortfall is not None and shortfall >= 1:
            needs.add(a.index)

    # candidate edges: aromatic order-1 bonds between two needs-atoms
    edges_at: dict[int, list[int]] = {i: [] for i in needs}
    for bi in arom_bonds:
        b = mol.bonds[bi]
        if b.a1 in needs and b.a2 in needs:
            edges_at[b.a1].append(bi)
            edges_at[b.a2].append(bi)

    # solve each connected component of the needs-graph independently:
    # failures stay local (no exponential re-exploration of unrelated
    # rings) and odd-sized components fail in O(1) — no perfect matching
    # can cover an odd vertex count
    matched: dict[int, int] = {}  # atom -> bond index
    seen: set[int] = set()
    budget = [200_000]
    for root in sorted(needs):
        if root in seen:
            continue
        group = []
        queue = [root]
        seen.add(root)
        while queue:
            v = queue.pop()
            group.append(v)
            for bi in edges_at[v]:
                u = mol.bonds[bi].other(v)
                if u in needs and u not in seen:
                    seen.add(u)
                    queue.append(u)
        if len(group) % 2 or not _match_kekule(
            group, edges_at, mol, matched, budget
        ):
            raise SmilesError(
                "no valid Kekulé structure for the aromatic system"
            )
    for bi in set(matched.values()):
        mol.bonds[bi].order = 2
    for b in mol.bonds:
        b.aromatic = False
    for a in mol.atoms:
        a.aromatic = False


def _match_kekule(
    atoms: list[int],
    edges_at: dict[int, list[int]],
    mol: Molecule,
    matched: dict[int, int],
    budget: list[int],
) -> bool:
    """Perfect matching over one needs-component by backtracking with
    dynamic most-constrained-first selection (an atom with one remaining
    option is forced, so chains and simple rings resolve without search).
    The work budget turns pathological inputs into a clean error instead
    of an effectively-infinite search."""
    free = [a for a in atoms if a not in matched]
    if not free:
        return True
    best, best_opts = None, None
    for a in free:
        opts = [
            bi for bi in edges_at[a] if mol.bonds[bi].other(a) not in matched
        ]
        if not opts:
            return False  # a needs-atom with no partner: dead branch
        if best_opts is None or len(opts) < len(best_opts):
            best, best_opts = a, opts
            if len(opts) == 1:
                break
    for bi in best_opts:
        budget[0] -= 1
        if budget[0] <= 0:
            raise SmilesError("kekulization exceeded its work budget")
        other = mol.bonds[bi].other(best)
        matched[best] = bi
        matched[other] = bi
        if _match_kekule(atoms, edges_at, mol, matched, budget):
            return True
        del matched[best]
        del matched[other]
    return False


def kekulized(mol: Molecule) -> Molecule:
    """Non-mutating :func:`kekulize` — returns a deep-copied molecule."""
    import copy

    out = copy.deepcopy(mol)
    kekulize(out)
    return out


def _upgrade_directional_ring_bonds(mol: Molecule) -> None:
    """Re-aromatize ring bonds written with stereo slashes.

    RDKit canonical SMILES can place an E/Z marker on a RING bond adjacent
    to an exocyclic double bond (e.g. ``[nH]/c(=N\\C(=O)OC)[nH]`` in the
    reference fixture). The marker forces the bond to parse as single, but
    RDKit's aromaticity re-perception makes it aromatic again. Mirror that:
    a direction-marked single bond between two aromatic atoms that lies on
    a cycle of all-aromatic atoms is aromatic."""
    for bi, b in enumerate(mol.bonds):
        if b.aromatic or b.order != 1 or not b.direction or not b.in_ring:
            continue
        a1, a2 = mol.atoms[b.a1], mol.atoms[b.a2]
        if a1.aromatic and a2.aromatic and _aromatic_path_exists(mol, bi):
            b.aromatic = True


def _aromatic_path_exists(mol: Molecule, bond_idx: int) -> bool:
    """True if the bond's endpoints connect through aromatic atoms only,
    avoiding the bond itself (i.e. the bond closes an all-aromatic cycle)."""
    b = mol.bonds[bond_idx]
    seen = {b.a1}
    queue = deque([b.a1])
    while queue:
        v = queue.popleft()
        for nbi in mol.neighbors(v):
            if nbi == bond_idx:
                continue
            u = mol.bonds[nbi].other(v)
            if u == b.a2:
                return True
            if u not in seen and mol.atoms[u].aromatic:
                seen.add(u)
                queue.append(u)
    return False


def _mark_rings(mol: Molecule) -> None:
    """Mark atoms/bonds in cycles: a bond is a ring bond iff removing it keeps
    its endpoints connected (cycle membership via bridge detection)."""
    n = len(mol.atoms)
    if n == 0:
        return
    # Tarjan bridge-finding, iterative
    disc = [-1] * n
    low = [0] * n
    is_bridge = [False] * len(mol.bonds)
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        stack = [(root, -1, iter(mol.neighbors(root)))]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            v, parent_bond, it = stack[-1]
            advanced = False
            for bi in it:
                if bi == parent_bond:
                    continue
                u = mol.bonds[bi].other(v)
                if disc[u] == -1:
                    disc[u] = low[u] = timer
                    timer += 1
                    stack.append((u, bi, iter(mol.neighbors(u))))
                    advanced = True
                    break
                low[v] = min(low[v], disc[u])
            if not advanced:
                stack.pop()
                if stack:
                    pv = stack[-1][0]
                    low[pv] = min(low[pv], low[v])
                    if low[v] > disc[pv]:
                        is_bridge[parent_bond] = True
    for bi, b in enumerate(mol.bonds):
        if not is_bridge[bi]:
            # bond in a cycle (or self-loop, which we disallow)
            mol.atoms[b.a1].in_ring = True
            mol.atoms[b.a2].in_ring = True
            b.in_ring = True


# ----------------------------------------------------------------- canonical


def canonical_ranks(mol: Molecule) -> list[int]:
    """Deterministic atom ranks by iterative invariant refinement
    (Morgan-style canonicalization with full tie-breaking)."""
    n = len(mol.atoms)
    inv = [
        (
            a.atomic_number,
            a.aromatic,
            a.charge,
            a.total_hs,
            mol.degree(i),
            a.in_ring,
            a.isotope,
        )
        for i, a in enumerate(mol.atoms)
    ]
    def refine(ranks):
        for _ in range(n):
            keys = []
            for i in range(n):
                neigh = sorted(
                    (mol.bonds[bi].order_value, ranks[mol.bonds[bi].other(i)])
                    for bi in mol.neighbors(i)
                )
                keys.append((ranks[i], tuple(neigh)))
            new_ranks = _ranks_from_keys(keys)
            if new_ranks == ranks:
                break
            ranks = new_ranks
        return ranks

    ranks = refine(_ranks_from_keys(inv))
    # Refinement can stall with tied-but-NONequivalent atoms, where an
    # input-index tie-break would make the "canonical" string depend on
    # input atom order (the same compound from two databases could then
    # fail SMILES dedup in the cross-DB merge). Strengthen the invariants
    # once with all-pairs (distance, rank) profiles: after that, remaining
    # ties are — for chemical graphs — true automorphisms, where any
    # tie-break choice yields the same output string.
    if len(set(ranks)) < n:
        # profiles are only needed to split TIED atoms — atoms with a
        # unique rank are already distinguished, so BFS only from the tied
        # ones (most molecules have a few tied atoms, not n)
        counts: dict[int, int] = {}
        for r in ranks:
            counts[r] = counts.get(r, 0) + 1
        dists = {
            i: _bfs_dists(mol, i)
            for i in range(n)
            if counts[ranks[i]] > 1
        }
        keys2 = [
            (
                ranks[i],
                tuple(sorted(
                    (dists[i][j], ranks[j]) for j in range(n) if j != i
                )) if i in dists else (),
            )
            for i in range(n)
        ]
        ranks = refine(_ranks_from_keys(keys2))
    # split remaining (automorphic) ties deterministically
    while len(set(ranks)) < n:
        dup_rank = min(r for r in ranks if ranks.count(r) > 1)
        chosen = min(i for i in range(n) if ranks[i] == dup_rank)
        keys2 = [(r, 0 if i == chosen else 1) for i, r in enumerate(ranks)]
        ranks = refine(_ranks_from_keys(keys2))
    return ranks


def _bfs_dists(mol: Molecule, src: int) -> list[int]:
    """Graph distances from ``src`` (disconnected atoms get a large
    sentinel so they still compare deterministically)."""
    n = len(mol.atoms)
    dist = [n + 1] * n
    dist[src] = 0
    queue = deque([src])
    while queue:
        v = queue.popleft()
        for u in mol.neighbor_atoms(v):
            if dist[u] > dist[v] + 1:
                dist[u] = dist[v] + 1
                queue.append(u)
    return dist


def _ranks_from_keys(keys) -> list[int]:
    order = {k: r for r, k in enumerate(sorted(set(keys)))}
    return [order[k] for k in keys]


_BOND_SYMBOL = {1: "", 2: "=", 3: "#", 4: "$"}


def write_smiles(mol: Molecule, kekule: bool = False) -> str:
    """Write a canonical SMILES (canonical within this implementation).

    ``kekule=True`` writes concrete bond orders instead of aromatic
    lowercase form (RDKit's ``MolToSmiles(..., kekuleSmiles=True)``)."""
    if kekule:
        mol = kekulized(mol)
    n = len(mol.atoms)
    if n == 0:
        return ""
    ranks = canonical_ranks(mol)

    def child_order(i: int):
        return sorted(
            mol.neighbors(i), key=lambda bi: (ranks[mol.bonds[bi].other(i)], bi)
        )

    # ---- pass 1: spanning-tree DFS; classify ring-closure (back) bonds ----
    visited = [False] * n
    tree_children: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    ring_bonds_at: list[list[int]] = [[] for _ in range(n)]  # both endpoints
    roots: list[int] = []
    used_bond = [False] * len(mol.bonds)
    # root each component at a terminal atom when one exists (canonical-rank
    # tie-broken) so chains read naturally ("CCO", not "C(C)O")
    root_order = sorted(
        range(n), key=lambda i: (min(mol.degree(i), 2), ranks[i], i)
    )
    for root in root_order:
        if visited[root]:
            continue
        roots.append(root)
        visited[root] = True
        order_stack = [(root, iter(child_order(root)))]
        while order_stack:
            v, it = order_stack[-1]
            for bi in it:
                if used_bond[bi]:
                    continue
                used_bond[bi] = True
                u = mol.bonds[bi].other(v)
                if visited[u]:
                    ring_bonds_at[v].append(bi)
                    ring_bonds_at[u].append(bi)
                else:
                    visited[u] = True
                    tree_children[v].append((bi, u))
                    order_stack.append((u, iter(child_order(u))))
                break
            else:
                order_stack.pop()

    # ---- pass 2: emit, opening/closing ring digits at both endpoints ----
    digit_free = list(range(99, 0, -1))
    open_digits: dict[int, int] = {}  # bond idx -> digit

    def atom_token(i: int) -> str:
        a = mol.atoms[i]
        needs_bracket = (
            (a.symbol not in _ORGANIC_SUBSET and a.symbol != "*")
            or a.charge != 0
            or a.isotope != 0
            or a.explicit_hs is not None
            # a reader of the unbracketed token must re-infer the same H
            # count (e.g. an aromatized Kekulé-input pyrrole N: bare "n"
            # would read as 0 Hs, so it must be written "[nH]")
            or _implicit_hs(mol, i) != a.total_hs
        )
        sym = a.symbol.lower() if a.aromatic else a.symbol
        if not needs_bracket:
            return sym
        h = a.total_hs
        htxt = "" if h == 0 else ("H" if h == 1 else f"H{h}")
        ctxt = ""
        if a.charge:
            sign = "+" if a.charge > 0 else "-"
            mag = abs(a.charge)
            ctxt = sign if mag == 1 else f"{sign}{mag}"
        iso = str(a.isotope) if a.isotope else ""
        return f"[{iso}{sym}{htxt}{ctxt}]"

    def bond_token(bi: int) -> str:
        b = mol.bonds[bi]
        if b.aromatic:
            return ""
        if b.order == 1 and mol.atoms[b.a1].aromatic and mol.atoms[b.a2].aromatic:
            return "-"  # explicit single bond between two aromatic atoms
        return _BOND_SYMBOL[b.order]

    def emit(i: int) -> str:
        out = [atom_token(i)]
        for bi in ring_bonds_at[i]:
            if bi in open_digits:  # closing end
                digit = open_digits.pop(bi)
                digit_free.append(digit)
                out.append(bond_token(bi) + _digit_txt(digit))
            else:  # opening end
                if not digit_free:
                    raise SmilesError(
                        "more than 99 ring closures open at once"
                    )
                digit = digit_free.pop()
                open_digits[bi] = digit
                out.append(bond_token(bi) + _digit_txt(digit))
        children = tree_children[i]
        for idx, (bi, j) in enumerate(children):
            sub = bond_token(bi) + emit(j)
            out.append(f"({sub})" if idx < len(children) - 1 else sub)
        return "".join(out)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * n + 100))
    try:
        return ".".join(emit(r) for r in roots)
    finally:
        sys.setrecursionlimit(old_limit)


def _digit_txt(d: int) -> str:
    return str(d) if d < 10 else f"%{d:02d}"


def canonical_smiles(smiles: str, kekule: bool = False) -> str:
    """Parse and re-write SMILES in this implementation's canonical form."""
    return write_smiles(parse_smiles(smiles), kekule=kekule)
