"""Gap-scored sequence alignment for ProteinNet mask repair.

The port's own copy of protein_transformer_tpu/data/align.py.

Dependency-free Needleman-Wunsch replacement for the reference's Biopython
aligner (reference: scripts/align_dataset_to_proteinnet.py:16-77), used to
reconcile self-measured structure sequences with ProteinNet's primary
sequence + mask when they do not merge directly. The reference configures
Biopython so that:

  * gaps in the target (ProteinNet primary) are impossible,
  * mismatches are impossible (observed residues must match exactly),
  * match = 10,
  * internal query gaps: open 49, extend 99 (prefer few, long gap runs),
  * edge query gaps: open 50, extend 100 (slight preference for gaps at the
    sequence ends).

Under those constraints every alignment is a monotone embedding of the
observed sequence into the primary, the match count is fixed, and the score
differences come only from gap-run structure -- reproduced here with an
affine-gap DP over numpy arrays. ``get_mask_from_alignment`` semantics:
'+' where an observed residue aligned, '-' at gaps.
"""
from __future__ import annotations

import numpy as np

MATCH = 10
GAP_OPEN = 49
GAP_EXTEND = 99
EDGE_GAP_OPEN = 50
EDGE_GAP_EXTEND = 100

_NEG = -(1 << 50)


def compute_alignment_mask(primary: str, observed: str) -> str | None:
    """Best-scoring embedding of ``observed`` into ``primary`` as a mask.

    Returns a string of '+'/'-' of len(primary), or None when no embedding
    exists (an observed residue has no matching primary residue in order).
    Parity: align_dataset_to_proteinnet.get_mask_from_alignment(:42-45) on
    the aligner of :16-40.
    """
    n, m = len(primary), len(observed)
    if m > n or m == 0:
        return None if m > n else "-" * n
    p = np.frombuffer(primary.encode("latin-1"), np.uint8)
    q = np.frombuffer(observed.encode("latin-1"), np.uint8)

    # M[i, j]: best score aligning primary[:i] to observed[:j], column i a
    # match; G[i, j]: same with column i a gap. Edge gaps: j == 0 or j == m.
    M = np.full((n + 1, m + 1), _NEG, np.int64)
    G = np.full((n + 1, m + 1), _NEG, np.int64)
    M[0, 0] = 0  # start state (no columns yet)

    js = np.arange(m + 1)
    edge = (js == 0) | (js == m)
    open_s = np.where(edge, EDGE_GAP_OPEN, GAP_OPEN)
    ext_s = np.where(edge, EDGE_GAP_EXTEND, GAP_EXTEND)

    for i in range(1, n + 1):
        prev_best = np.maximum(M[i - 1], G[i - 1])
        # match at column i consumes observed[j-1]
        eq = p[i - 1] == q
        feasible = eq & (prev_best[:-1] > _NEG)
        M[i, 1:] = np.where(feasible, prev_best[:-1] + MATCH, _NEG)
        # gap at column i keeps j
        from_m = np.where(M[i - 1] > _NEG, M[i - 1] + open_s, _NEG)
        from_g = np.where(G[i - 1] > _NEG, G[i - 1] + ext_s, _NEG)
        G[i] = np.maximum(from_m, from_g)

    if max(M[n, m], G[n, m]) <= _NEG:
        return None

    # exact traceback from the score matrices
    mask = []
    i, j = n, m
    in_gap = G[n, m] > M[n, m]
    while i > 0:
        if in_gap:
            mask.append("-")
            # which predecessor achieved G[i, j]?
            in_gap = (G[i - 1, j] > _NEG
                      and G[i, j] == G[i - 1, j] + ext_s[j]
                      and not (M[i - 1, j] > _NEG
                               and G[i, j] == M[i - 1, j] + open_s[j]))
            i -= 1
        else:
            mask.append("+")
            target = M[i, j] - MATCH
            in_gap = not (M[i - 1, j - 1] == target)
            i -= 1
            j -= 1
    return "".join(reversed(mask))


def can_be_directly_merged(primary: str, observed: str,
                           pn_mask: str) -> tuple[bool, str | None]:
    """True iff some optimal embedding of observed into primary yields
    exactly pn_mask; also returns a computed mask usable as a repair.

    Parity: align_dataset_to_proteinnet.can_be_directly_merged(:47-77).
    Because mismatches are impossible, an alignment whose mask equals
    pn_mask exists iff primary restricted to pn_mask spells observed -- that
    direct check replaces Biopython's enumeration of co-optimal alignments.
    """
    if len(pn_mask) == len(primary):
        masked = "".join(c for c, s in zip(primary, pn_mask) if s == "+")
        if masked == observed:
            return True, pn_mask
    computed = compute_alignment_mask(primary, observed)
    return (computed == pn_mask), computed


def binary_mask_to_str(mask) -> str:
    """[1, 0, 1] -> '+-+' (align_dataset_to_proteinnet:80-86)."""
    return "".join("+" if int(x) else "-" for x in mask)


def str_mask_to_binary(mask: str) -> list[int]:
    return [1 if c == "+" else 0 for c in mask]
