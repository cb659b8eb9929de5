"""Tip and bubble removal on the unitig graph (reference C6/C7).

This module is the NORMATIVE SPEC: the rules below, written as plain
Python over Unitig objects, define simplification semantics for every
path. The oracle runs this code directly; the device pipelines run the
vectorized mirror (``host.simplify_arrays`` — O(U) array passes over a
segment view, no string churn), which is property-tested equal to this
implementation on the same inputs. Keep the two in lockstep: any rule
change lands here first, then in the array mirror, with a parity test.

Rules (normative, strand-symmetric, deterministic — SURVEY.md §7 hard parts):

Tip: a unitig with exactly one dead end (no unitig feeds its start, or none
leaves its end), at most ``tip_len`` k-mer edges long, attached at its live
end to a junction that has an alternative branch in the same direction with
coverage >= the tip's. All qualifying tips are removed simultaneously per
round, which preserves strand symmetry (a tip's reverse-complement twin
always qualifies in the same round).

Bubble: >= 2 unitig arms sharing both endpoints (start node s, end node t),
each at most ``bubble_len`` edges. Keep the arm with the highest coverage,
tie-broken by smallest *canonical* sequence (canonical, not raw, so the
choice agrees between a bubble and its reverse-complement twin bubble),
then by smallest raw sequence (revcomp twin arms have EQUAL canonicals;
the raw comparison keeps the rule a pure function of the arm set, never
of the order unitigs happen to be listed in — the array-native mirror
must reach identical decisions from a differently-ordered set); delete
the rest.

After each removal round, non-branching chains of surviving unitigs are
merged (unitig-level recompression) and the passes repeat to fixpoint.
"""

from __future__ import annotations

from ..utils.dna import canonical_str
from .dbg import (
    Unitig,
    UnitigGraph,
    both_strand_edges,
    build_unitig_graph,
    compress_unitigs,
)

_MAX_ROUNDS = 64


def merge_chains(unitigs: list[Unitig], k: int) -> list[Unitig]:
    """Merge non-branching chains of unitigs (unitig-level recompression).

    Equivalent to deleting nothing and recompressing the k-mer graph: a
    boundary node stops being a junction only when deletions bring it to
    in == out == 1, and then its two incident unitigs merge.
    Deterministic: walks start from unitigs in sorted-sequence order.
    """
    order = sorted(range(len(unitigs)), key=lambda i: unitigs[i].seq)
    out_at: dict[str, list[int]] = {}
    in_at: dict[str, list[int]] = {}
    for i in order:
        out_at.setdefault(unitigs[i].start, []).append(i)
        in_at.setdefault(unitigs[i].end, []).append(i)

    def is_junction(node: str) -> bool:
        return len(out_at.get(node, ())) != 1 or len(in_at.get(node, ())) != 1

    consumed = [False] * len(unitigs)
    merged: list[Unitig] = []

    def walk(first: int, stop_node: str | None) -> None:
        chain = [first]
        consumed[first] = True
        node = unitigs[first].end
        while not is_junction(node) and node != stop_node:
            nxt = out_at[node][0]
            if consumed[nxt]:
                break
            chain.append(nxt)
            consumed[nxt] = True
            node = unitigs[nxt].end
        parts = [unitigs[chain[0]].seq]
        parts.extend(unitigs[i].seq[k - 1 :] for i in chain[1:])
        edges = sum(unitigs[i].edges for i in chain)
        cov_sum = sum(unitigs[i].cov_sum for i in chain)
        merged.append(
            Unitig(seq="".join(parts), cov_sum=cov_sum, edges=edges, k=k)
        )

    for i in order:
        if not consumed[i] and is_junction(unitigs[i].start):
            walk(i, stop_node=None)
    for i in order:  # pure unitig cycles
        if not consumed[i]:
            walk(i, stop_node=unitigs[i].start)
    return merged


def _find_tips(g: UnitigGraph, tip_len: int) -> list[int]:
    tips: list[int] = []
    for i, u in enumerate(g.unitigs):
        if u.edges > tip_len:
            continue
        start_dead = len(g.in_ids(u.start)) == 0
        end_dead = len(g.out_ids(u.end)) == 0
        if start_dead == end_dead:
            # both dead: isolated contig, keep; neither dead: internal chain.
            continue
        if start_dead:
            # Tip flows into junction t == u.end; alternatives are other
            # unitigs that also flow into t.
            siblings = [j for j in g.in_ids(u.end) if j != i]
        else:
            siblings = [j for j in g.out_ids(u.start) if j != i]
        if any(g.unitigs[j].cov >= u.cov for j in siblings):
            tips.append(i)
    return tips


def _find_bubble_losers(g: UnitigGraph, bubble_len: int) -> list[int]:
    groups: dict[tuple[str, str], list[int]] = {}
    for i, u in enumerate(g.unitigs):
        if u.edges <= bubble_len:
            groups.setdefault((u.start, u.end), []).append(i)
    losers: list[int] = []
    for arms in groups.values():
        if len(arms) < 2:
            continue
        # Keep max coverage, tie-break smallest canonical sequence.
        keep = max(
            arms,
            key=lambda i: (g.unitigs[i].cov, _neg_canon(g.unitigs[i].seq)),
        )
        losers.extend(i for i in arms if i != keep)
    return losers


class _neg_canon:
    """Order-reversing wrapper so max() prefers the smallest (canonical,
    raw) sequence pair — see the module docstring's bubble rule."""

    __slots__ = ("s",)

    def __init__(self, seq: str) -> None:
        self.s = (canonical_str(seq), seq)

    def __lt__(self, other: "_neg_canon") -> bool:
        return self.s > other.s

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _neg_canon) and self.s == other.s


def _find_low_cov_islands(
    g: UnitigGraph, tip_len: int, min_count: int
) -> list[int]:
    """Short, low-coverage, fully isolated unitigs (error islands).

    A cluster of same-substitution errors can survive the coverage filter
    (at 100x, P[>= min_count identical errors at one site] is small but
    the genome offers ~3*len(genome) chances), and once its neighbors are
    filtered it is an island — both ends dead — which tip removal
    deliberately keeps. Rule (normative, deterministic, strand-symmetric;
    standard low-coverage contig pruning): drop a unitig iff NO other
    unitig touches either endpoint, it spans <= tip_len edges, its
    coverage barely cleared the filter (< 2 * min_count — genuine
    sequence sits at sequencing depth, error survivors hug the cutoff),
    and it is < 1/4 of the edge-weighted median coverage. Genuine short
    contigs are untouched, as are circular islands (self-adjacent).
    """
    total = sum(u.edges for u in g.unitigs)
    if total == 0:
        return []
    half = total / 2
    acc = 0
    median = g.unitigs[-1].cov if g.unitigs else 0.0
    for i in sorted(range(len(g.unitigs)), key=lambda j: g.unitigs[j].cov):
        acc += g.unitigs[i].edges
        if acc >= half:
            median = g.unitigs[i].cov
            break
    doomed = []
    for i, u in enumerate(g.unitigs):
        if (
            u.edges > tip_len
            or u.cov >= 2 * min_count
            or u.cov >= 0.25 * median
        ):
            continue
        isolated = (
            len(g.in_ids(u.start)) == 0
            and len(g.out_ids(u.end)) == 0
            and g.out_ids(u.start) == [i]
            and g.in_ids(u.end) == [i]
        )
        if isolated:
            doomed.append(i)
    return doomed


def simplify_unitigs(
    unitigs: list[Unitig], k: int, tip_len: int, bubble_len: int,
    min_count: int = 1,
) -> UnitigGraph:
    """Iterate tip + bubble + island removal (with chain re-merging) to
    fixpoint. min_count anchors the error-island rule (the resolved
    coverage-filter threshold of the run)."""
    for _ in range(_MAX_ROUNDS):
        g = build_unitig_graph(unitigs, k)
        doomed = set(_find_tips(g, tip_len))
        if not doomed:
            doomed = set(_find_bubble_losers(g, bubble_len))
        if not doomed:
            doomed = set(_find_low_cov_islands(g, tip_len, min_count))
        if not doomed:
            return g
        survivors = [u for i, u in enumerate(unitigs) if i not in doomed]
        unitigs = merge_chains(survivors, k)
    return build_unitig_graph(unitigs, k)


def simplify_counts(
    canonical_counts: dict[str, int],
    k: int,
    tip_len: int,
    bubble_len: int,
    min_count: int = 1,
) -> UnitigGraph:
    """Canonical counts -> simplified strand-symmetric unitig graph."""
    edges = both_strand_edges(canonical_counts)
    unitigs = compress_unitigs(edges, k)
    return simplify_unitigs(unitigs, k, tip_len, bubble_len, min_count)
