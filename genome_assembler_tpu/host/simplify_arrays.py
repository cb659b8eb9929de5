"""Array-native tip/bubble/island simplification (reference C6/C7 at scale).

``host.simplify`` defines the normative rules as plain Python over
``Unitig`` objects — clear, but O(U) Python-object and string churn per
round. This module is the production implementation: the same fixpoint
(tips; else bubbles; else low-coverage islands; remove; merge chains)
computed on packed NumPy arrays with no per-unitig Python loops and no
string materialization until the final graph is built.

Representation: a **segment view** over one immutable 2-bit code buffer.
Each unitig is a list of (src, len) slices; removal drops rows, chain
merging concatenates slice lists (trimming the k-1 overlap off non-head
members — provably always inside their first segment), and per-unitig
start/end (k-1)-mer node keys are carried through merges (a merged
chain's start node is its head's, its end node its last member's). A
round therefore touches O(U) elements, never O(total bases); bases move
exactly twice — once packing in, once materializing the final graph.
That matters beyond asymptotics: per-round buffer rebuilds were measured
slower than the Python path on hosts with slow allocators.

Decision parity with the normative rules is exact, not approximate:
  * every coverage comparison is an IEEE-f64 operation on ``cov_sum /
    edges`` — ``Unitig.cov`` computes the same division, so both paths
    compare identical doubles (the integer ``cov_sum`` refactor removed
    float accumulation order from merging);
  * the rare exact ties (bubble arms with equal coverage) fall back to
    the same (canonical, raw)-sequence rule, decoding only the tied arms
    — a pure function of the arm set, so the two paths agree even though
    they hold the unitigs in different orders after merges;
  * chain merging reproduces the host walk: unique-successor links,
    pointer doubling, pure cycles broken before their lexicographically
    smallest-sequence member (matching ``merge_chains``'s seq-ordered
    walk start).

Property-tested equal to ``simplify_unitigs`` on random branchy inputs
(tests/test_simplify_arrays.py) and pinned by every end-to-end
oracle-equality test, since the device pipelines call this path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.dna import canonical_str
from .dbg import Unitig, UnitigGraph, build_unitig_graph

_MAX_ROUNDS = 64  # matches host.simplify._MAX_ROUNDS


@dataclasses.dataclass
class UnitigArrays:
    """Columnar unitig set: 2-bit codes + offsets + exact coverage sums.

    buf:     uint8 base codes (0..3) of all unitig sequences, concatenated.
    off:     int64 [U+1] sequence offsets into buf.
    edges:   int64 [U] k-mer edge counts (strlen == k-1 + edges).
    cov_sum: int64 [U] summed edge multiplicities.
    """

    buf: np.ndarray
    off: np.ndarray
    edges: np.ndarray
    cov_sum: np.ndarray
    k: int

    @property
    def num(self) -> int:
        return len(self.edges)

    def seq(self, i: int) -> str:
        from .dbg import _DECODE_LUT

        return (
            _DECODE_LUT[self.buf[self.off[i] : self.off[i + 1]]]
            .tobytes()
            .decode()
        )


def build_unitig_arrays(
    bases: np.ndarray,
    lengths: np.ndarray,
    cov_sum: np.ndarray,
    head_words: np.ndarray,
    k: int,
) -> UnitigArrays:
    """Assemble UnitigArrays from the compact spell transfer set.

    bases:      [sum(lengths)] uint8 codes — the last base of every edge in
                global (uid, pos) order (the concatenation of all unitig
                bodies, unitig order).
    lengths:    [U] edge counts per unitig.
    cov_sum:    [U] summed edge multiplicities per unitig.
    head_words: [U, W] uint32 — each unitig's head edge k-mer; its prefix
                spells the first k-1 bases.

    Shared final-assembly step of every spell path (host.dbg
    .spell_device_arrays single-device, parallel.compress sharded paths);
    pure vectorized NumPy in host RAM.
    """
    u = len(lengths)
    if u == 0:  # e.g. a coverage filter that dropped every k-mer
        return UnitigArrays(
            buf=np.empty(0, dtype=np.uint8),
            off=np.zeros(1, dtype=np.int64),
            edges=np.empty(0, dtype=np.int64),
            cov_sum=np.empty(0, dtype=np.int64),
            k=k,
        )
    lengths = lengths.astype(np.int64)
    w = head_words.shape[1]
    total_body = int(lengths.sum())
    str_len = (k - 1) + lengths
    offsets = np.zeros(u + 1, dtype=np.int64)
    np.cumsum(str_len, out=offsets[1:])
    buf = np.empty(int(offsets[-1]), dtype=np.uint8)

    # bodies: the sorted base stream is the concatenation of unitig bodies
    body_excl = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    body_start = offsets[:-1] + (k - 1)
    if u <= 8192:
        # few (usually long) unitigs: plain slice copies — cheaper than
        # materializing a fancy index the size of the genome
        for i in range(u):
            s = int(body_excl[i])
            ln = int(lengths[i])
            d = int(body_start[i])
            buf[d : d + ln] = bases[s : s + ln]
    else:
        # many short unitigs: one fancy scatter. int32 indices halve the
        # index-build traffic, but buf = total_body + U*(k-1) bytes can
        # exceed 2^31 on a fragmented graph (the edge-table bound caps
        # only total_body), so the dtype follows the buffer size.
        idx_dt = (
            np.int32 if offsets[-1] <= np.iinfo(np.int32).max else np.int64
        )
        dest = np.repeat(
            (body_start - body_excl).astype(idx_dt), lengths
        ) + np.arange(total_body, dtype=idx_dt)
        buf[dest] = bases[:total_body]
    # heads: first k-1 bases decoded from each unitig's head edge k-mer
    head_off = offsets[:-1]
    for j in range(k - 1):
        bitpos = 2 * (k - 1 - j)
        widx = w - 1 - bitpos // 32
        b = (head_words[:, widx] >> np.uint32(bitpos % 32)) & np.uint32(3)
        buf[head_off + j] = b.astype(np.uint8)
    return UnitigArrays(
        buf=buf,
        off=offsets,
        edges=lengths,
        cov_sum=cov_sum.astype(np.int64),
        k=k,
    )


def from_unitigs(unitigs: list[Unitig], k: int) -> UnitigArrays:
    """Pack a Unitig list into columnar arrays (adapter for tests/host)."""
    from ..utils.dna import encode_seq

    lens = np.array([len(u.seq) for u in unitigs], dtype=np.int64)
    off = np.zeros(len(unitigs) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    buf = np.empty(int(off[-1]), dtype=np.uint8)
    for i, u in enumerate(unitigs):
        buf[off[i] : off[i + 1]] = encode_seq(u.seq)
    return UnitigArrays(
        buf=buf,
        off=off,
        edges=np.array([u.edges for u in unitigs], dtype=np.int64),
        cov_sum=np.array([u.cov_sum for u in unitigs], dtype=np.int64),
        k=k,
    )


def to_unitig_list(ua: UnitigArrays) -> list[Unitig]:
    """Decode columnar unitigs into Unitig objects (one bulk LUT pass).

    The single decode surface — to_unitig_graph and both spell wrappers
    (host.dbg.spell_device_unitigs, parallel.compress.spell_quads_host)
    share it.
    """
    from .dbg import _DECODE_LUT

    raw = _DECODE_LUT[ua.buf].tobytes()
    return [
        Unitig(
            seq=raw[ua.off[i] : ua.off[i + 1]].decode(),
            cov_sum=int(ua.cov_sum[i]),
            edges=int(ua.edges[i]),
            k=ua.k,
        )
        for i in range(ua.num)
    ]


def to_unitig_graph(ua: UnitigArrays) -> UnitigGraph:
    """Materialize strings (once, at the end) and build the UnitigGraph."""
    return build_unitig_graph(to_unitig_list(ua), ua.k)


# ---------------------------------------------------------------------------
# segment view


@dataclasses.dataclass
class _Segs:
    """Unitigs as slice lists over an immutable code buffer.

    seg_src/seg_len: [S] source slices, stored in unitig order (within a
    unitig, slices concatenate to its sequence).
    uoff:            [U+1] unitig -> slice span.
    sk/ek:           [U, 2] uint64 packed start/end (k-1)-mer node keys,
                     carried through merges so no round reads the buffer.
    """

    buf: np.ndarray
    seg_src: np.ndarray
    seg_len: np.ndarray
    uoff: np.ndarray
    edges: np.ndarray
    cov_sum: np.ndarray
    sk: np.ndarray
    ek: np.ndarray
    k: int

    @property
    def num(self) -> int:
        return len(self.edges)

    def seq(self, i: int) -> str:
        from .dbg import _DECODE_LUT

        lo, hi = self.uoff[i], self.uoff[i + 1]
        codes = np.concatenate(
            [
                self.buf[s : s + l]
                for s, l in zip(self.seg_src[lo:hi], self.seg_len[lo:hi])
            ]
        )
        return _DECODE_LUT[codes].tobytes().decode()


def _pack_keys(buf: np.ndarray, pos: np.ndarray, k1: int) -> np.ndarray:
    """[N] start positions -> [N, 2] uint64 packed (k-1)-mer keys."""
    hi = np.zeros(len(pos), dtype=np.uint64)
    lo = np.zeros(len(pos), dtype=np.uint64)
    for j in range(k1):
        b = buf[pos + j].astype(np.uint64)
        if j < 31:  # 31 bases in hi, the rest (<= 31 more, k <= 63) in lo
            hi = (hi << np.uint64(2)) | b
        else:
            lo = (lo << np.uint64(2)) | b
    return np.stack([hi, lo], axis=1)


def _segs_from_arrays(ua: UnitigArrays) -> _Segs:
    u = ua.num
    k1 = ua.k - 1
    lens = ua.off[1:] - ua.off[:-1]
    return _Segs(
        buf=ua.buf,
        seg_src=ua.off[:-1].astype(np.int64),
        seg_len=lens.astype(np.int64),
        uoff=np.arange(u + 1, dtype=np.int64),
        edges=np.asarray(ua.edges, dtype=np.int64),
        cov_sum=np.asarray(ua.cov_sum, dtype=np.int64),
        sk=_pack_keys(ua.buf, ua.off[:-1], k1),
        ek=_pack_keys(ua.buf, ua.off[1:] - k1, k1),
        k=ua.k,
    )


def _segs_to_arrays(sg: _Segs) -> UnitigArrays:
    """One O(total bases) gather materializes the surviving sequences."""
    k1 = sg.k - 1
    if sg.num == 0:  # every unitig doomed (e.g. all tips of an X)
        return UnitigArrays(
            buf=np.empty(0, dtype=np.uint8),
            off=np.zeros(1, dtype=np.int64),
            edges=sg.edges,
            cov_sum=sg.cov_sum,
            k=sg.k,
        )
    strlen = sg.edges + k1
    off = np.zeros(sg.num + 1, dtype=np.int64)
    np.cumsum(strlen, out=off[1:])
    total = int(off[-1])
    nseg = len(sg.seg_src)
    if nseg <= 8192:
        # few (usually long) slices: plain copies — no genome-sized
        # index array (measured ~7s -> ~10ms at CFG-2 scale)
        buf = np.empty(total, dtype=np.uint8)
        dst = 0
        for s, ln in zip(sg.seg_src, sg.seg_len):
            buf[dst : dst + ln] = sg.buf[s : s + ln]
            dst += ln
        return UnitigArrays(
            buf=buf, off=off, edges=sg.edges, cov_sum=sg.cov_sum, k=sg.k
        )
    # many short slices: one fancy gather. int32 indices halve the
    # index-build traffic, but both the source buffer (total_body +
    # U*(k-1) bytes) and the output can exceed 2^31 on a fragmented
    # graph, so the dtype follows the larger of the two (mirrors
    # build_unitig_arrays).
    idx_dt = (
        np.int32
        if max(total, len(sg.buf)) <= np.iinfo(np.int32).max
        else np.int64
    )
    excl = np.concatenate([[0], np.cumsum(sg.seg_len)[:-1]])
    src = np.repeat(
        (sg.seg_src - excl).astype(idx_dt), sg.seg_len
    ) + np.arange(total, dtype=idx_dt)
    return UnitigArrays(
        buf=sg.buf[src], off=off, edges=sg.edges, cov_sum=sg.cov_sum, k=sg.k
    )


def _node_ids(sg: _Segs) -> tuple[np.ndarray, np.ndarray]:
    """Dense node ids for the cached start/end keys (one lexsort)."""
    u = sg.num
    keys = np.concatenate([sg.sk, sg.ek], axis=0)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    ks = keys[order]
    new = np.ones(2 * u, dtype=bool)
    new[1:] = (ks[1:, 0] != ks[:-1, 0]) | (ks[1:, 1] != ks[:-1, 1])
    rank_sorted = np.cumsum(new) - 1
    rank = np.empty(2 * u, dtype=np.int64)
    rank[order] = rank_sorted
    return rank[:u], rank[u:]


def _take(sg: _Segs, keep: np.ndarray) -> _Segs:
    """Drop doomed unitigs (and their slices); O(S), no buffer touch."""
    cnt = np.diff(sg.uoff)
    segkeep = np.repeat(keep, cnt)
    new_cnt = cnt[keep]
    uoff = np.zeros(int(keep.sum()) + 1, dtype=np.int64)
    np.cumsum(new_cnt, out=uoff[1:])
    return _Segs(
        buf=sg.buf,
        seg_src=sg.seg_src[segkeep],
        seg_len=sg.seg_len[segkeep],
        uoff=uoff,
        edges=sg.edges[keep],
        cov_sum=sg.cov_sum[keep],
        sk=sg.sk[keep],
        ek=sg.ek[keep],
        k=sg.k,
    )


# ---------------------------------------------------------------------------
# round decisions (vectorized mirrors of host.simplify rules)


def _group_top2(gid: np.ndarray, vals: np.ndarray, ngroups: int):
    """Per-group (max, second max) of vals; second is -inf for singletons."""
    m1 = np.full(ngroups, -np.inf)
    m2 = np.full(ngroups, -np.inf)
    if len(gid) == 0:
        return m1, m2
    order = np.lexsort((vals, gid))
    g, v = gid[order], vals[order]
    last = np.ones(len(g), dtype=bool)
    last[:-1] = g[:-1] != g[1:]
    m1[g[last]] = v[last]
    second = np.zeros(len(g), dtype=bool)
    second[:-1] = last[1:] & (g[:-1] == g[1:])
    m2[g[second]] = v[second]
    return m1, m2


def _find_tips_arr(
    sg: _Segs, sid, eid, in_n, out_n, covf, tip_len: int
) -> np.ndarray:
    """Vectorized mirror of host.simplify._find_tips (same rule text)."""
    nn = max(int(in_n.shape[0]), int(out_n.shape[0]))
    start_dead = in_n[sid] == 0
    end_dead = out_n[eid] == 0
    cand = (sg.edges <= tip_len) & (start_dead != end_dead)
    # siblings of a start-dead tip: other unitigs ending at its end node;
    # of an end-dead tip: other unitigs starting at its start node.
    m1_in, m2_in = _group_top2(eid, covf, nn)
    m1_out, m2_out = _group_top2(sid, covf, nn)
    m1 = np.where(start_dead, m1_in[eid], m1_out[sid])
    m2 = np.where(start_dead, m2_in[eid], m2_out[sid])
    # any(sibling cov >= cov_u): the group max beats u, or u is the max
    # and the second entry ties/exceeds it
    has_ge_sibling = (m1 > covf) | (m2 >= covf)
    return cand & has_ge_sibling


def _find_bubble_losers_arr(
    sg: _Segs, sid, eid, covf, bubble_len: int
) -> np.ndarray:
    """Vectorized mirror of host.simplify._find_bubble_losers.

    Winner per (start, end) group: max coverage — resolved vectorized
    when the f64 max is unique; exact ties fall back to the smallest
    canonical sequence (then first in index order), decoding only the
    tied arms — identical to the host ``max`` over a (cov, _neg_canon)
    key on arms listed in index order.
    """
    doomed = np.zeros(sg.num, dtype=bool)
    cand = np.nonzero(sg.edges <= bubble_len)[0]
    if len(cand) < 2:
        return doomed
    order = cand[np.lexsort((cand, covf[cand], eid[cand], sid[cand]))]
    s, e = sid[order], eid[order]
    new = np.ones(len(order), dtype=bool)
    new[1:] = (s[1:] != s[:-1]) | (e[1:] != e[:-1])
    bounds = np.nonzero(new)[0]
    sizes = np.diff(np.append(bounds, len(order)))
    multi = sizes >= 2
    if not multi.any():
        return doomed
    b_multi = bounds[multi]
    sz_multi = sizes[multi]
    ends = b_multi + sz_multi - 1  # per-group max-cov element (cov-sorted)
    cv = covf[order]
    tied = cv[ends] == cv[ends - 1]  # second-highest ties the max
    # members of every >=2 group are doomed, then winners are un-doomed
    grp_id = np.cumsum(new) - 1
    members_mask = multi[grp_id]
    doomed[order[members_mask]] = True
    doomed[order[ends[~tied]]] = False  # unique-max winners
    for b, size in zip(b_multi[tied], sz_multi[tied]):
        arms = order[b : b + size]
        cva = covf[arms]
        top = cva == cva.max()
        tied_arms = arms[top]
        # (canonical, raw) pair — identical to the normative _neg_canon
        # rule and a pure function of the arm set, independent of the
        # order this path happens to hold the unitigs in
        seqs = [sg.seq(int(i)) for i in tied_arms]
        keys = [(canonical_str(q), q) for q in seqs]
        keep = tied_arms[min(range(len(tied_arms)), key=lambda j: keys[j])]
        doomed[keep] = False
    return doomed


def _find_islands_arr(
    sg: _Segs, sid, eid, in_n, out_n, covf, tip_len: int, min_count: int
) -> np.ndarray:
    """Vectorized mirror of host.simplify._find_low_cov_islands."""
    total = int(sg.edges.sum())
    if total == 0:
        return np.zeros(sg.num, dtype=bool)
    half = total / 2
    order = np.argsort(covf, kind="stable")
    cum = np.cumsum(sg.edges[order])
    median = covf[order[int(np.argmax(cum >= half))]]
    isolated = (
        (in_n[sid] == 0)
        & (out_n[eid] == 0)
        & (out_n[sid] == 1)
        & (in_n[eid] == 1)
    )
    return (
        (sg.edges <= tip_len)
        & (covf < 2 * min_count)
        & (covf < 0.25 * median)
        & isolated
    )


# ---------------------------------------------------------------------------
# chain merging


def _merge_chains_segs(sg: _Segs, sid=None, eid=None) -> _Segs:
    """Vectorized mirror of host.simplify.merge_chains on the segment view.

    Unique-successor links where a boundary node has in == out == 1,
    chain heads/offsets by pointer doubling (NumPy gathers), pure
    unitig-level cycles broken before their smallest-sequence member
    (the host walk starts there). Merging is pure slice-list surgery:
    non-head members lose their k-1 overlap (always inside their first
    slice: a first slice is an original never-trimmed head slice of
    length >= k, and trimmed slices become interior forever), and the
    chain inherits its head's start key and its last member's end key.

    sid/eid: node ids for sg's rows, if the caller already has them (the
    round loop computes them for its decisions; node keys are untouched
    by removal, so the subset slices stay valid — skipping the second
    per-round _node_ids lexsort, the dominant per-round sort).
    """
    u = sg.num
    if u == 0:
        return sg
    k1 = sg.k - 1
    if sid is None or eid is None:
        sid, eid = _node_ids(sg)
    nn = int(max(sid.max(), eid.max())) + 1
    out_n = np.bincount(sid, minlength=nn)
    in_n = np.bincount(eid, minlength=nn)
    starter = np.full(nn, -1, dtype=np.int64)
    starter[sid] = np.arange(u)
    ender = np.full(nn, -1, dtype=np.int64)
    ender[eid] = np.arange(u)
    thru = (out_n == 1) & (in_n == 1)  # node merges its in- into out-unitig
    prev = np.where(thru[sid], ender[sid], -1)

    ids = np.arange(u, dtype=np.int64)
    steps = max(1, int(np.ceil(np.log2(max(u, 2)))) + 1)

    def doubling(prev):
        anc = np.where(prev >= 0, prev, ids)
        dist = (prev >= 0).astype(np.int64)
        mn = np.minimum(ids, anc)
        for _ in range(steps):
            dist = dist + dist[anc]
            mn = np.minimum(mn, mn[anc])
            anc = anc[anc]
        return anc, dist, mn

    anc, dist, mn = doubling(prev)
    in_cycle = prev[anc] >= 0  # ancestor never reached a head
    if in_cycle.any():
        # break each cycle before its smallest-sequence member, matching
        # the host walk's seq-sorted start; mn names the cycle (its
        # minimum member id covers the whole ring after doubling)
        breaks = []
        for rep in np.unique(mn[in_cycle]):
            members = np.nonzero(in_cycle & (mn == rep))[0]
            if len(members) == 1:
                breaks.append(int(members[0]))
            else:
                seqs = [sg.seq(int(i)) for i in members]
                breaks.append(
                    int(members[min(range(len(members)), key=seqs.__getitem__)])
                )
        prev[np.array(breaks, dtype=np.int64)] = -1
        anc, dist, _ = doubling(prev)

    heads = prev == -1
    if heads.all():
        return sg  # nothing merges
    chain = (np.cumsum(heads) - 1)[anc]
    nchains = int(heads.sum())
    order = np.lexsort((dist, chain))  # members in chain-walk order

    # trim the k-1 overlap off every non-head member's first slice
    seg_src = sg.seg_src.copy()
    seg_len = sg.seg_len.copy()
    first_seg = sg.uoff[:-1][~heads]
    seg_src[first_seg] += k1
    seg_len[first_seg] -= k1

    # reorder slices from unitig order to (chain, dist) order
    cnt = np.diff(sg.uoff)
    cnt_o = cnt[order]
    s_total = int(cnt_o.sum())
    excl = np.concatenate([[0], np.cumsum(cnt_o)[:-1]])
    seg_take = (
        np.repeat(sg.uoff[:-1][order], cnt_o)
        + np.arange(s_total, dtype=np.int64)
        - np.repeat(excl, cnt_o)
    )
    # per-chain sums via cumsum-diff over the (chain, dist)-sorted order:
    # exact int64 (bincount's float64 weight accumulation would round
    # above 2^53, breaking integer-coverage parity at extreme scale)
    chain_sizes = np.bincount(chain, minlength=nchains)
    bnd = np.cumsum(chain_sizes)  # end-exclusive member index per chain

    def chain_sum(vals: np.ndarray) -> np.ndarray:
        cs = np.concatenate([[0], np.cumsum(vals[order])])
        return cs[bnd] - cs[bnd - chain_sizes]

    uoff = np.zeros(nchains + 1, dtype=np.int64)
    np.cumsum(chain_sum(cnt), out=uoff[1:])
    head_ids = np.nonzero(heads)[0]  # ascending == chain id order
    last_members = order[bnd - 1]
    return _Segs(
        buf=sg.buf,
        seg_src=seg_src[seg_take],
        seg_len=seg_len[seg_take],
        uoff=uoff,
        edges=chain_sum(sg.edges),
        cov_sum=chain_sum(sg.cov_sum),
        sk=sg.sk[head_ids],
        ek=sg.ek[last_members],
        k=sg.k,
    )


# ---------------------------------------------------------------------------
# fixpoint


def simplify_arrays(
    ua: UnitigArrays, tip_len: int, bubble_len: int, min_count: int = 1
) -> UnitigArrays:
    """Fixpoint of tips -> bubbles -> islands with chain re-merging.

    Same round structure and gating as host.simplify.simplify_unitigs;
    given the same unitig set it deletes the same unitigs every round
    (property-tested).
    """
    sg = _segs_from_arrays(ua)
    changed = False
    for _ in range(_MAX_ROUNDS):
        if sg.num == 0:
            break
        sid, eid = _node_ids(sg)
        nn = int(max(sid.max(), eid.max())) + 1
        in_n = np.bincount(eid, minlength=nn)
        out_n = np.bincount(sid, minlength=nn)
        covf = sg.cov_sum / sg.edges  # one f64 division, == Unitig.cov
        doomed = _find_tips_arr(sg, sid, eid, in_n, out_n, covf, tip_len)
        if not doomed.any():
            doomed = _find_bubble_losers_arr(sg, sid, eid, covf, bubble_len)
        if not doomed.any():
            doomed = _find_islands_arr(
                sg, sid, eid, in_n, out_n, covf, tip_len, min_count
            )
        if not doomed.any():
            break
        changed = True
        keep = ~doomed
        sg = _merge_chains_segs(_take(sg, keep), sid[keep], eid[keep])
    if not changed:
        # clean graph (the common error-free case): every segment is the
        # original one-slice-per-unitig view — skip rematerializing
        return ua
    return _segs_to_arrays(sg)


def simplify_arrays_to_graph(
    ua: UnitigArrays, tip_len: int, bubble_len: int, min_count: int = 1
) -> UnitigGraph:
    """Simplify columnar unitigs and materialize the final UnitigGraph."""
    return to_unitig_graph(simplify_arrays(ua, tip_len, bubble_len, min_count))
