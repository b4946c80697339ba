"""Native SMILES parser — no RDKit dependency.

The reference featurizer is built on RDKit (reference:
src/datasets/features.py:153-334).  RDKit is a heavyweight C++ dependency
that is not guaranteed in TPU images, so this framework ships its own
host-side SMILES parser covering the organic chemistry the model family
targets (QM9-class molecules and general drug-like SMILES):

- organic subset + bracket atoms (isotope, chirality, H-count, charge)
- branches, ring closures (incl. %nn), dot-separated fragments
- aromatic perception with kekulization (backtracking perfect matching)
- implicit hydrogen assignment per OpenSMILES normal-valence rules
- directional bonds (/ \\) for double-bond stereo, tetrahedral tags (@ @@)
- explicit-H expansion (AddHs equivalent: H atoms appended after heavy
  atoms, in heavy-atom order, matching RDKit's AddHs layout)

Known deviations from RDKit (documented, see chem/featurize.py):
- canonical SMILES output is not reproduced (we keep the input string);
- "potential" (unassigned) stereocenter detection uses symmetry-rank
  refinement rather than full CIP rules.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

from .periodic import (
    AROMATIC_ORGANIC,
    DEFAULT_VALENCES,
    ELEMENTS,
    ORGANIC_SUBSET,
    SYMBOL_TO_Z,
    VALENCE_ELECTRONS,
)


class SmilesError(ValueError):
    pass


@dataclasses.dataclass
class Atom:
    atomic_num: int
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    chiral: int = 0  # 0 none, 1 '@', 2 '@@'
    bracket: bool = False
    explicit_h: int = 0  # H count from bracket (only valid if bracket)
    implicit_h: int = 0  # computed for organic-subset atoms
    is_h: bool = False

    @property
    def symbol(self) -> str:
        return ELEMENTS[self.atomic_num - 1]

    @property
    def total_h(self) -> int:
        return self.explicit_h if self.bracket else self.implicit_h


@dataclasses.dataclass
class Bond:
    a1: int
    a2: int
    order: int  # 1, 2, 3, 4 (after kekulization for aromatic bonds)
    aromatic: bool = False
    direction: int = 0  # +1 '/' , -1 '\' as written from a1 to a2

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1


class Molecule:
    """A parsed molecular graph (pre- or post- explicit-H expansion)."""

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Optional[List[List[int]]] = None  # atom -> bond indices
        # Per-atom neighbor order in SMILES convention (OpenSMILES §3.9.2):
        # preceding atom, then the bracket implicit-H slot (sentinel -1,
        # patched to the real H index by add_hydrogens), then ring-closure
        # partners at their DIGIT positions, then branch/chain neighbors as
        # written.  Consumed by the tetrahedral-stereo re-emission in
        # write_canonical_smiles.
        self.sorder: List[List[int]] = []

    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self.sorder.append([])
        self._adj = None
        return len(self.atoms) - 1

    def add_bond(self, a1: int, a2: int, order: int, aromatic=False, direction=0) -> int:
        self.bonds.append(Bond(a1, a2, order, aromatic, direction))
        self._adj = None
        return len(self.bonds) - 1

    @property
    def adjacency(self) -> List[List[int]]:
        if self._adj is None:
            adj: List[List[int]] = [[] for _ in self.atoms]
            for bi, b in enumerate(self.bonds):
                adj[b.a1].append(bi)
                adj[b.a2].append(bi)
            self._adj = adj
        return self._adj

    def neighbors(self, idx: int) -> List[int]:
        return [self.bonds[bi].other(idx) for bi in self.adjacency[idx]]

    def bond_order_sum(self, idx: int) -> int:
        return sum(self.bonds[bi].order for bi in self.adjacency[idx])

    def num_atoms(self) -> int:
        return len(self.atoms)


_TWO_LETTER = {"Cl", "Br"}  # organic subset two-letter symbols
_BOND_ORDERS = {"-": 1, "=": 2, "#": 3, "$": 4, ":": 1}


def _parse_bracket(s: str, i: int) -> Tuple[Atom, int]:
    """Parse a bracket atom starting at s[i] == '['; return (atom, next_i)."""
    j = s.index("]", i)
    body = s[i + 1 : j]
    k = 0
    isotope = 0
    while k < len(body) and body[k].isdigit():
        isotope = isotope * 10 + int(body[k])
        k += 1
    # element symbol (possibly aromatic lowercase)
    aromatic = False
    if k < len(body) and body[k : k + 2] in SYMBOL_TO_Z and body[k].isupper():
        # prefer two-letter if valid and next char is lowercase alpha that
        # forms a known element
        two = body[k : k + 2]
        one = body[k]
        if len(two) == 2 and two[1].islower() and two in SYMBOL_TO_Z:
            sym, k = two, k + 2
        else:
            sym, k = one, k + 1
    elif k < len(body) and body[k].isupper():
        sym, k = body[k], k + 1
    elif k < len(body) and body[k].islower():
        # aromatic symbol (c, n, o, s, p, b, se, as)
        if body[k : k + 2] in ("se", "as"):
            sym, k = body[k : k + 2].capitalize(), k + 2
        else:
            sym, k = body[k].upper(), k + 1
        aromatic = True
    else:
        raise SmilesError(f"Bad bracket atom: [{body}]")
    if sym == "*":
        raise SmilesError("Wildcard atoms not supported")
    if sym not in SYMBOL_TO_Z:
        raise SmilesError(f"Unknown element: {sym}")

    chiral = 0
    if k < len(body) and body[k] == "@":
        chiral = 1
        k += 1
        if k < len(body) and body[k] == "@":
            chiral = 2
            k += 1
        # Extended chirality classes like @TH1 — accept and skip
        for tag in ("TH1", "TH2", "AL1", "AL2", "SP1", "SP2", "SP3"):
            if body[k : k + len(tag)] == tag:
                k += len(tag)
                break

    h_count = 0
    if k < len(body) and body[k] == "H":
        k += 1
        h_count = 1
        n = 0
        while k < len(body) and body[k].isdigit():
            n = n * 10 + int(body[k])
            k += 1
        if n:
            h_count = n

    charge = 0
    while k < len(body) and body[k] in "+-":
        sign = 1 if body[k] == "+" else -1
        k += 1
        n = 0
        while k < len(body) and body[k].isdigit():
            n = n * 10 + int(body[k])
            k += 1
        charge += sign * (n if n else 1)

    # atom-map class: ':' digits — parse and ignore
    if k < len(body) and body[k] == ":":
        k += 1
        while k < len(body) and body[k].isdigit():
            k += 1

    if k != len(body):
        raise SmilesError(f"Trailing characters in bracket atom: [{body}]")

    z = SYMBOL_TO_Z[sym]
    atom = Atom(
        atomic_num=z,
        aromatic=aromatic,
        charge=charge,
        isotope=isotope,
        chiral=chiral,
        bracket=True,
        explicit_h=h_count,
        is_h=(z == 1),
    )
    return atom, j + 1


def parse_smiles(smiles: str) -> Molecule:
    """Parse a SMILES string into a kekulized Molecule with implicit-H counts.

    Raises SmilesError on malformed input (callers treat that like the
    reference treats ``Chem.MolFromSmiles == None``)."""
    try:
        return _parse_smiles(smiles)
    except SmilesError:
        raise
    except (ValueError, IndexError) as e:
        # malformed syntax surfacing as str.index/int errors must still be
        # a SmilesError so featurizers drop the row instead of crashing
        raise SmilesError(f"Malformed SMILES {smiles!r}: {e}") from None


def _parse_smiles(smiles: str) -> Molecule:
    mol = Molecule()
    prev: Optional[int] = None
    stack: List[Optional[int]] = []
    # ring number -> (atom_idx, bond_char or None, direction, sorder pos)
    rings: Dict[int, Tuple[int, Optional[str], int, int]] = {}
    pending_bond: Optional[str] = None  # one of -=#$:/\
    i, n = 0, len(smiles)

    def _attach(new_idx: int) -> None:
        nonlocal prev, pending_bond
        if prev is not None:
            a1, a2 = prev, new_idx
            if pending_bond in ("/", "\\"):
                order, arom, direction = 1, False, (1 if pending_bond == "/" else -1)
            elif pending_bond is not None:
                order, arom, direction = _BOND_ORDERS[pending_bond], pending_bond == ":", 0
            else:
                both_arom = mol.atoms[a1].aromatic and mol.atoms[a2].aromatic
                order, arom, direction = 1, both_arom, 0
            mol.add_bond(a1, a2, order, arom, direction)
            mol.sorder[a1].append(a2)
            mol.sorder[a2].append(a1)
        if mol.atoms[new_idx].bracket and mol.atoms[new_idx].explicit_h > 0:
            mol.sorder[new_idx].append(-1)  # implicit-H slot (OpenSMILES)
        prev = new_idx
        pending_bond = None

    while i < n:
        c = smiles[i]
        if c == "[":
            atom, i = _parse_bracket(smiles, i)
            _attach(mol.add_atom(atom))
        elif c.isalpha() or c == "*":
            if c == "*":
                raise SmilesError("Wildcard atoms not supported")
            two = smiles[i : i + 2]
            if two in _TWO_LETTER:
                sym, i = two, i + 2
                aromatic = False
            elif c.isupper():
                sym, i = c, i + 1
                aromatic = False
                if sym not in ORGANIC_SUBSET:
                    raise SmilesError(f"Atom '{sym}' must be written in brackets")
            else:
                if c not in AROMATIC_ORGANIC:
                    raise SmilesError(f"Bad aromatic atom '{c}'")
                sym, i = c.upper(), i + 1
                aromatic = True
            atom = Atom(atomic_num=SYMBOL_TO_Z[sym], aromatic=aromatic)
            _attach(mol.add_atom(atom))
        elif c in "-=#$:/\\":
            if pending_bond is not None:
                raise SmilesError("Two bond symbols in a row")
            pending_bond = c
            i += 1
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("Unmatched ')'")
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        elif c.isdigit() or c == "%":
            if prev is None:
                raise SmilesError("Ring closure before any atom")
            if c == "%":
                num = int(smiles[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            direction = (
                1 if pending_bond == "/" else (-1 if pending_bond == "\\" else 0)
            )
            bond_char = pending_bond if pending_bond not in ("/", "\\") else None
            if num in rings:
                open_atom, open_char, open_dir, open_pos = rings.pop(num)
                char = bond_char or open_char
                if bond_char and open_char and bond_char != open_char:
                    raise SmilesError("Conflicting ring-closure bond orders")
                if char is not None:
                    order, arom = _BOND_ORDERS[char], char == ":"
                else:
                    arom = mol.atoms[open_atom].aromatic and mol.atoms[prev].aromatic
                    order = 1
                # direction as written from the opening atom
                d = open_dir if open_dir else (-direction if direction else 0)
                mol.add_bond(open_atom, prev, order, arom, d)
                mol.sorder[open_atom][open_pos] = prev
                mol.sorder[prev].append(open_atom)
            else:
                rings[num] = (prev, bond_char, direction, len(mol.sorder[prev]))
                mol.sorder[prev].append(-2)  # patched at ring closure
            pending_bond = None
        elif c in " \t":
            break  # SMILES may be followed by a title
        else:
            raise SmilesError(f"Unexpected character {c!r}")

    if rings:
        raise SmilesError(f"Unclosed ring bonds: {sorted(rings)}")
    if stack:
        raise SmilesError("Unclosed branch '('")
    if pending_bond is not None:
        raise SmilesError("Dangling bond symbol")
    if not mol.atoms:
        raise SmilesError("Empty SMILES")

    _kekulize(mol)
    _assign_implicit_hydrogens(mol)
    return mol


def _kekulize(mol: Molecule) -> None:
    """Assign alternating double bonds within aromatic systems.

    Each aromatic atom that must carry one double bond ("needy": aromatic C
    without an existing explicit double bond, pyridine-type N/P, charged
    aromatic O/S) is matched to exactly one aromatic-bond neighbor by a
    backtracking perfect matching; matched bonds become order 2.
    """
    needy = set()
    for idx, atom in enumerate(mol.atoms):
        if not atom.aromatic:
            continue
        # existing explicit double/triple bond (e.g. quinoid c(=O)) satisfies it
        has_multiple = any(
            mol.bonds[bi].order >= 2 and not mol.bonds[bi].aromatic
            for bi in mol.adjacency[idx]
        )
        if has_multiple:
            continue
        sym = atom.symbol
        n_conn = len(mol.adjacency[idx]) + atom.total_h if atom.bracket else len(
            mol.adjacency[idx]
        )
        if sym == "C":
            if atom.charge == 0:
                needy.add(idx)
            # c+ / c- (e.g. tropylium/cyclopentadienyl): no double required
        elif sym in ("N", "P"):
            if atom.bracket and atom.explicit_h > 0:
                continue  # pyrrole-type [nH]
            if atom.charge == -1:
                continue  # [n-]
            if n_conn >= 3 and atom.charge == 0:
                continue  # substituted pyrrole-type n
            needy.add(idx)  # pyridine-type (2 connections) or [n+] with 3
        elif sym in ("O", "S", "Se"):
            if atom.charge == 1:
                needy.add(idx)  # pyrylium-type
        elif sym == "B":
            continue
        else:
            continue

    if not needy:
        return

    # candidate aromatic bonds between needy atoms
    cand: Dict[int, List[Tuple[int, int]]] = {a: [] for a in needy}
    for bi, b in enumerate(mol.bonds):
        if b.aromatic and b.a1 in needy and b.a2 in needy:
            cand[b.a1].append((b.a2, bi))
            cand[b.a2].append((b.a1, bi))

    order = sorted(needy, key=lambda a: len(cand[a]))
    matched: Dict[int, int] = {}
    chosen: List[int] = []

    def backtrack(pos: int) -> bool:
        while pos < len(order) and order[pos] in matched:
            pos += 1
        if pos == len(order):
            return True
        a = order[pos]
        for nbr, bi in cand[a]:
            if nbr not in matched:
                matched[a] = nbr
                matched[nbr] = a
                chosen.append(bi)
                if backtrack(pos + 1):
                    return True
                chosen.pop()
                del matched[a], matched[nbr]
        return False

    if not backtrack(0):
        raise SmilesError("Kekulization failed (non-alternating aromatic system)")
    for bi in chosen:
        mol.bonds[bi].order = 2


def _assign_implicit_hydrogens(mol: Molecule) -> None:
    for idx, atom in enumerate(mol.atoms):
        if atom.bracket:
            atom.implicit_h = 0
            continue
        sym = atom.symbol
        valences = DEFAULT_VALENCES.get(sym)
        if valences is None:
            atom.implicit_h = 0
            continue
        bsum = mol.bond_order_sum(idx)
        atom.implicit_h = next((v - bsum for v in valences if v >= bsum), 0)


def add_hydrogens(mol: Molecule) -> Molecule:
    """Expand implicit/bracket H counts into explicit H atoms.

    Heavy atoms keep their indices; H atoms are appended afterwards in
    heavy-atom order (RDKit AddHs layout, so downstream index-based features
    are comparable)."""
    out = Molecule()
    for i, atom in enumerate(mol.atoms):
        out.add_atom(dataclasses.replace(atom))
        out.sorder[i] = list(mol.sorder[i])
    for b in mol.bonds:
        out.add_bond(b.a1, b.a2, b.order, b.aromatic, b.direction)
    for idx in range(len(mol.atoms)):
        atom = out.atoms[idx]
        for _ in range(atom.total_h):
            h = out.add_atom(Atom(atomic_num=1, is_h=True))
            out.add_bond(idx, h, 1)
            so = out.sorder[idx]
            if -1 in so:  # the bracket implicit-H slot (stereo convention)
                so[so.index(-1)] = h
            else:
                so.append(h)
            out.sorder[h] = [idx]
        atom.explicit_h = 0
        atom.implicit_h = 0
    return out


def hybridization(mol: Molecule, idx: int) -> str:
    """Estimate hybridization (S/SP/SP2/SP3/SP3D/SP3D2/OTHER).

    Aromatic atoms are SP2; otherwise steric number = σ-bonds + lone pairs
    with lone pairs from main-group valence electron counts.  This matches
    RDKit on organic molecules (the model only consumes the 6-way index with
    an OOV bucket, reference: src/datasets/constants.py:11-18)."""
    atom = mol.atoms[idx]
    if atom.aromatic:
        return "SP2"
    ve = VALENCE_ELECTRONS.get(atom.atomic_num)
    if ve is None:
        return "OTHER"
    sigma = len(mol.adjacency[idx]) + atom.total_h
    bsum = mol.bond_order_sum(idx) + atom.total_h
    lone_pairs = max(0, (ve - atom.charge - bsum) // 2)
    steric = sigma + lone_pairs
    return {1: "S", 2: "SP", 3: "SP2", 4: "SP3", 5: "SP3D", 6: "SP3D2"}.get(
        steric, "OTHER"
    )


def total_formal_charge(mol: Molecule) -> int:
    return sum(a.charge for a in mol.atoms)


_CIP_NODE_BUDGET = 65536
# Explicit depth bound (shared with native/featurizer.cpp) so long-chain
# molecules take the deterministic symmetry-rank fallback in BOTH
# languages instead of Python hitting RecursionError (nondeterministic wrt
# surrounding stack) while the C++ twin recurses on the native stack.
_CIP_MAX_DEPTH = 512


class _CipBudget(Exception):
    pass


def _cip_key(mol: Molecule, prev: int, cur: int, mask: List[bool], counter,
             depth: int = 0):
    """Canonical key of one branch of the CIP hierarchical digraph.

    The digraph follows CIP constitutional rules (rule 1a atomic number +
    rule 2 isotope): multiple bonds contribute phantom duplicate leaves at
    BOTH ends, ring closures terminate in a duplicate leaf of the revisited
    atom, and sibling subtrees are order-canonicalized by sorting — so two
    branches compare equal iff their hierarchical digraphs are isomorphic
    (reference behavior: RDKit FindMolChiralCenters(includeUnassigned=True)
    via AssignStereochemistry; src/datasets/features.py:211-218).

    Keys are nested tuples ``(Z, isotope, (children…))``; duplicates are
    ``(Z, 0, ())``.  Raises ``_CipBudget`` past ``_CIP_NODE_BUDGET`` nodes
    (pathological fused polycycles) — callers fall back to symmetry ranks.
    """
    counter[0] += 1
    if counter[0] > _CIP_NODE_BUDGET or depth > _CIP_MAX_DEPTH:
        raise _CipBudget()
    a = mol.atoms[cur]
    children = []
    for bi in mol.adjacency[cur]:
        b = mol.bonds[bi]
        other = b.other(cur)
        dup = (mol.atoms[other].atomic_num, 0, ())
        for _ in range(b.order - 1):  # phantom atoms for multiple bonds
            children.append(dup)
        if other == prev:
            continue
        if mask[other]:  # ring closure → duplicate leaf
            children.append(dup)
        else:
            mask[cur] = True
            children.append(_cip_key(mol, cur, other, mask, counter, depth + 1))
            mask[cur] = False
    children.sort(reverse=True)
    return (a.atomic_num, a.isotope, tuple(children))


def cip_neighbors_distinct(mol: Molecule, idx: int) -> Optional[bool]:
    """True iff the four substituent branches at ``idx`` are pairwise
    constitutionally distinct under the CIP hierarchical digraph; None if
    the digraph exceeds the node budget (caller falls back to the
    symmetry-rank approximation)."""
    mask = [False] * len(mol.atoms)
    mask[idx] = True
    counter = [0]
    try:
        keys = [
            _cip_key(mol, idx, j, mask, counter) for j in mol.neighbors(idx)
        ]
    except (_CipBudget, RecursionError):
        return None
    return len(set(keys)) == len(keys)


def chiral_tag_is_stereogenic(mol: Molecule, idx: int,
                              ranks_cache: Optional[list] = None) -> bool:
    """AssignStereochemistry(cleanIt=True) analog (reference:
    src/datasets/features.py:169-176 cleans bogus tags before
    FindMolChiralCenters): an assigned @/@@ tag is kept only when the atom
    has four neighbors whose CIP branches are pairwise constitutionally
    distinct — [C@@]1(F)(Cl)CC1-style tags on non-stereogenic atoms are
    dropped by the writer and emit no tet_nbrs row.  Digraph-budget
    overflow falls back to the symmetry-rank approximation.  Mirrored in
    native/featurizer.cpp::chiral_tag_is_stereogenic.

    ``ranks_cache`` is an optional 1-element list caching symmetry_ranks
    across calls on the same molecule."""
    nbrs = mol.neighbors(idx)
    if len(nbrs) != 4:
        return False
    distinct = cip_neighbors_distinct(mol, idx)
    if distinct is None:
        if ranks_cache is None:
            ranks_cache = [None]
        if ranks_cache[0] is None:
            ranks_cache[0] = symmetry_ranks(mol)
        distinct = len({ranks_cache[0][j] for j in nbrs}) == 4
    return distinct


def canonical_ranks(mol: Molecule) -> List[int]:
    """Distinct per-atom canonical ranks for the SMILES writer.

    Hash-free Morgan/WL refinement over explicit invariant tuples
    (language-portable: native/featurizer.cpp mirrors it exactly), then
    deterministic tie-breaking: repeatedly single out one member of the
    lowest tied class and re-refine.  Within an automorphism orbit the
    choice cannot affect the emitted string; for WL-indistinguishable yet
    non-automorphic atoms (chemically exotic regular graphs) the output
    may depend on input order — documented in PARITY.md.
    """
    n = len(mol.atoms)

    def compress(keys):
        uniq = {k: r for r, k in enumerate(sorted(set(keys)))}
        return [uniq[k] for k in keys]

    def refine(ranks):
        while True:
            keys = [
                (
                    ranks[i],
                    tuple(
                        sorted(
                            (ranks[mol.bonds[bi].other(i)], mol.bonds[bi].order)
                            for bi in mol.adjacency[i]
                        )
                    ),
                )
                for i in range(n)
            ]
            new = compress(keys)
            if new == ranks:
                return ranks
            ranks = new

    ranks = refine(
        compress(
            [
                (
                    a.is_h,
                    a.atomic_num,
                    a.charge,
                    a.total_h,
                    len(mol.adjacency[i]),
                    a.aromatic,
                    a.isotope,
                )
                for i, a in enumerate(mol.atoms)
            ]
        )
    )
    while len(set(ranks)) < n:
        counts: Dict[int, int] = {}
        for r in ranks:
            counts[r] = counts.get(r, 0) + 1
        r0 = min(r for r, c in counts.items() if c > 1)
        chosen = min(i for i in range(n) if ranks[i] == r0)
        ranks = refine(
            compress([(ranks[i], 0 if i == chosen else 1) for i in range(n)])
        )
    return ranks


_BOND_CHAR = {1: "", 2: "=", 3: "#", 4: "$"}


def _bond_char_out(mol: Molecule, bi: int, u: int) -> str:
    """Bond symbol when the bond is written starting from atom ``u``."""
    b = mol.bonds[bi]
    if b.direction:
        d = b.direction if b.a1 == u else -b.direction
        return "/" if d > 0 else "\\"
    if b.aromatic:
        return ""
    if (
        b.order == 1
        and mol.atoms[b.a1].aromatic
        and mol.atoms[b.a2].aromatic
    ):
        return "-"  # single (non-aromatic) bond between aromatic atoms
    return _BOND_CHAR[b.order]


def _perm_parity_even(src: List[int], dst: List[int]) -> bool:
    perm = [src.index(x) for x in dst]
    inv = sum(
        1
        for i in range(len(perm))
        for j in range(i + 1, len(perm))
        if perm[i] > perm[j]
    )
    return inv % 2 == 0


def _atom_str(mol: Molecule, u: int, out_order: List[int],
              keep_chiral=None) -> str:
    """Bracket-atom text (allHsExplicit semantics: every atom bracketed,
    like the reference's ``MolToSmiles(..., allHsExplicit=True)``).

    ``keep_chiral``: set of atoms whose @/@@ tag survived the cleanIt
    analog (:func:`chiral_tag_is_stereogenic`); None keeps all tags."""
    a = mol.atoms[u]
    sym = a.symbol.lower() if a.aromatic else a.symbol
    s = "["
    if a.isotope:
        s += str(a.isotope)
    s += sym
    if a.chiral and (keep_chiral is None or u in keep_chiral):
        ref = mol.sorder[u]
        if len(ref) == 4 and len(out_order) == 4 and set(ref) == set(out_order):
            tag = a.chiral if _perm_parity_even(ref, out_order) else 3 - a.chiral
            s += "@" if tag == 1 else "@@"
    if a.total_h:
        s += "H" + ("" if a.total_h == 1 else str(a.total_h))
    if a.charge:
        s += ("+" if a.charge > 0 else "-") + (
            str(abs(a.charge)) if abs(a.charge) > 1 else ""
        )
    return s + "]"


def _directional_systems(mol: Molecule):
    """Directional-bond canonicalization support.

    Returns (active, find): ``active`` is the set of single-bond indices
    whose direction marks are meaningful (incident to a double bond whose
    BOTH ends carry directional bonds — the reference's stereo-bond
    condition, src/datasets/features.py:220-236); ``find`` maps an active
    bond to its system representative.  Flipping every mark inside one
    system preserves the encoded stereochemistry, so the writer flips each
    system to start with '/' — making e.g. F/C=C/F and F\\C=C\\F emit the
    same canonical string.  Marks not in ``active`` are dropped.
    """
    dir_at: Dict[int, List[int]] = {}
    for bi, b in enumerate(mol.bonds):
        if b.order == 1 and b.direction:
            dir_at.setdefault(b.a1, []).append(bi)
            dir_at.setdefault(b.a2, []).append(bi)
    parent: Dict[int, int] = {}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    active: set = set()
    for b in mol.bonds:
        if b.order != 2 or b.aromatic:
            continue
        d1 = dir_at.get(b.a1, [])
        d2 = dir_at.get(b.a2, [])
        if not d1 or not d2:
            continue
        grp = d1 + d2
        for bi in grp:
            active.add(bi)
            parent.setdefault(bi, bi)
        for bi in grp[1:]:
            union(grp[0], bi)
    return active, find


def write_canonical_smiles(mol: Molecule) -> str:
    """Deterministic canonical SMILES of a parsed Molecule.

    Analog of the reference's processed-SMILES output
    ``Chem.MolToSmiles(mol, isomericSmiles=True, allHsExplicit=True)``
    after AddHs (reference: src/datasets/features.py:173): every atom is
    bracketed, tetrahedral tags are re-oriented to the emission order via
    the recorded OpenSMILES neighbor order, and double-bond stereo is
    preserved by re-emitting the input's directional marks in the output
    orientation.  The canonicalization algorithm is our own
    (:func:`canonical_ranks`), so strings differ from RDKit's canonical
    form byte-wise while carrying the same information (PARITY.md).
    """
    n = mol.num_atoms()
    ranks = canonical_ranks(mol)
    dir_sys = _directional_systems(mol)
    # cleanIt analog: tags on non-stereogenic atoms are not emitted, so
    # [C@@]1(F)(Cl)CC1 and its tag-free writing canonicalize identically.
    ranks_cache = [None]
    keep_chiral = {
        i
        for i, a in enumerate(mol.atoms)
        if a.chiral and chiral_tag_is_stereogenic(mol, i, ranks_cache)
    }
    # DFS discovery/emission recurse once per atom; lift Python's default
    # 1000-frame limit for big molecules (restored below).
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        return _write_canonical_smiles(mol, ranks, dir_sys, keep_chiral)
    finally:
        sys.setrecursionlimit(old_limit)


def _write_canonical_smiles(mol, ranks, dir_sys, keep_chiral) -> str:
    n = mol.num_atoms()
    seen = [False] * n
    roots = []
    for start in sorted(range(n), key=lambda i: ranks[i]):
        if seen[start]:
            continue
        roots.append(start)
        stack = [start]
        seen[start] = True
        while stack:
            u = stack.pop()
            for v in mol.neighbors(u):
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
    return ".".join(
        _write_fragment(mol, ranks, root, dir_sys, keep_chiral)
        for root in roots
    )


def _write_fragment(mol: Molecule, ranks: List[int], root: int, dir_sys,
                    keep_chiral=None) -> str:
    # Pass 1: DFS discovery — children in canonical-rank order; edges to
    # already-visited atoms become ring closures (digit printed at BOTH
    # endpoints; bond char at the closing side).
    children: Dict[int, List[Tuple[int, int]]] = {}
    ring_open: Dict[int, List[int]] = {}  # atom -> bonds whose digit opens here
    ring_close: Dict[int, List[int]] = {}  # atom -> bonds whose digit closes here
    visited = set()
    done_bonds = set()

    def discover(u: int) -> None:
        visited.add(u)
        children[u] = []
        nbrs = sorted(
            ((bi, mol.bonds[bi].other(u)) for bi in mol.adjacency[u]),
            key=lambda t: (ranks[t[1]], t[0]),
        )
        for bi, v in nbrs:
            if bi in done_bonds:
                continue
            done_bonds.add(bi)
            if v in visited:
                ring_close.setdefault(u, []).append(bi)
                ring_open.setdefault(v, []).append(bi)
            else:
                children[u].append((v, bi))
                discover(v)

    discover(root)

    # Pass 2: emission with digit allocation/reuse.  Directional marks are
    # emitted as ("D", system, char) placeholders so each directional
    # system can be canonically flipped to start with '/' afterwards.
    active, find = dir_sys
    out: List[object] = []
    digit_of: Dict[int, int] = {}
    in_use: set = set()

    def take_digit() -> int:
        d = 1
        while d in in_use:
            d += 1
        in_use.add(d)
        return d

    def digit_str(d: int) -> str:
        return str(d) if d < 10 else f"%{d:02d}"

    def bond_str(bi: int, u: int) -> None:
        b = mol.bonds[bi]
        if b.direction:
            if bi in active:
                d = b.direction if b.a1 == u else -b.direction
                out.append(("D", find(bi), "/" if d > 0 else "\\"))
            # inactive marks (no stereo double bond attached) are dropped
            return
        out.append(_bond_char_out(mol, bi, u))

    def emit(u: int, parent: Optional[int]) -> None:
        order = [parent] if parent is not None else []
        order += [mol.bonds[bi].other(u) for bi in ring_open.get(u, [])]
        order += [mol.bonds[bi].other(u) for bi in ring_close.get(u, [])]
        order += [v for v, _ in children[u]]
        out.append(_atom_str(mol, u, order, keep_chiral))
        for bi in ring_open.get(u, []):
            digit_of[bi] = take_digit()
            out.append(digit_str(digit_of[bi]))
        for bi in ring_close.get(u, []):
            d = digit_of.pop(bi)
            in_use.discard(d)
            bond_str(bi, u)
            out.append(digit_str(d))
        ch = children[u]
        for k, (v, bi) in enumerate(ch):
            last = k == len(ch) - 1
            if not last:
                out.append("(")
            bond_str(bi, u)
            emit(v, u)
            if not last:
                out.append(")")

    emit(root, None)
    # canonical flip: each directional system starts with '/'
    flip: Dict[int, bool] = {}
    for tok in out:
        if isinstance(tok, tuple) and tok[1] not in flip:
            flip[tok[1]] = tok[2] == "\\"
    return "".join(
        (("\\" if (tok[2] == "/") == flip[tok[1]] else "/")
         if isinstance(tok, tuple) else tok)
        for tok in out
    )


def symmetry_ranks(mol: Molecule) -> List[int]:
    """Canonical-ish symmetry classes via iterative neighborhood refinement
    (Morgan/Weisfeiler-Lehman).  Used for potential-stereocenter detection."""
    ranks = [
        hash((a.atomic_num, a.charge, a.total_h, len(mol.adjacency[i]), a.aromatic))
        for i, a in enumerate(mol.atoms)
    ]
    # compress to small ints
    def compress(vals):
        uniq = {v: r for r, v in enumerate(sorted(set(vals)))}
        return [uniq[v] for v in vals]

    ranks = compress(ranks)
    for _ in range(len(mol.atoms)):
        new = []
        for i in range(len(mol.atoms)):
            nb = sorted(
                (ranks[mol.bonds[bi].other(i)], mol.bonds[bi].order)
                for bi in mol.adjacency[i]
            )
            new.append(hash((ranks[i], tuple(nb))))
        new = compress(new)
        if new == ranks:
            break
        ranks = new
    return ranks
