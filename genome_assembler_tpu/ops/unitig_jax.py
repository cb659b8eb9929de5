"""On-device unitig compression by pointer jumping (SURVEY.md §7 M4).

The reference walks non-branching chains one edge at a time on the host
(SURVEY.md §3.4); here the non-branching 95% of the graph is compressed in
O(log E) doubling sweeps of fixed-shape gathers — the array-native
restructuring mandated by the north star ("Eulerian path traversal
restructured as iterative parallel unitig compression (pointer-jumping /
list-ranking on non-branching chains)", BASELINE.json).

Pipeline (all static shapes, capacity = 2C directed edges):
  1. both-strand edge table: canonical k-mers + their reverse complements,
     lexicographically sorted — edge id == sorted position;
  2. successor linking: edge e chains into the unique edge whose prefix
     node equals suffix(e) iff that node has outdeg == indeg == 1, found
     by one merged sort of tagged prefix/suffix node keys
     (_link_sortjoin);
  3. chain heads via pointer doubling on the predecessor pointers, with
     min-id tracking to break pure cycles deterministically at their
     lexicographically smallest edge (matching host compress_unitigs);
  4. outputs (edge -> unitig id, position, coverage) are spelled into
     strings on the host by vectorized NumPy (host/dbg.spell_unitigs).

Semantics are bit-identical to host compress_unitigs on the same counts
(tested); only the mechanics are parallel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .count_jax import CountTable, sort_by_words
from .kmer_jax import SENTINEL
from .words_jax import prefix_node, revcomp_words, suffix_node


class DeviceUnitigs(NamedTuple):
    """Edge-level unitig assignment, capacity 2C (invalid lanes masked).

    edge_words: [E, W] sorted directed edge k-mers (both strands).
    cov:        [E] int32 multiplicity per edge.
    uid:        [E] int32 unitig id (dense, 0..num_unitigs-1) or -1 invalid.
    pos:        [E] int32 position of the edge within its unitig chain.
    valid:      [E] bool.
    num_unitigs: scalar int32.
    """

    edge_words: jax.Array
    cov: jax.Array
    uid: jax.Array
    pos: jax.Array
    valid: jax.Array
    num_unitigs: jax.Array


def _doubling(prev: jax.Array, steps: int, track: str = "dist"):
    """Pointer doubling over predecessor pointers.

    prev[e] = predecessor edge id or -1. Heads (prev == -1) self-loop, so
    the ancestor converges to the chain head. track selects the second
    quantity carried along:
      "dist" -> distance from the head (chain offset);
      "min"  -> minimum edge id on the ancestor path (cycle break point —
                for pure cycles the ancestor keeps rotating and the min
                covers the whole cycle).

    (anc, aux) ride one [E, 2] array so each round is a single row
    gather instead of two.

    The loop exits early once the state stops changing — rounds needed
    are ceil(log2(longest chain)), not ceil(log2(E)), so graphs whose
    unitigs are short (post-filter real data) finish in a handful of
    gather rounds. Cycle semantics are preserved exactly: in a pure
    cycle the dist column doubles forever (so a cyclic graph runs all
    `steps` rounds and trips the 2^steps detector in _rank_pass), and
    in min-tracking the state can only stabilize after the minimum has
    propagated around the whole cycle.
    Returns (ancestor, tracked, changed) — ``changed`` is True iff the
    loop exhausted ``steps`` rounds without reaching a fixpoint (cycles,
    or chains longer than 2^steps), which the sampled fast path uses as
    its exact-fallback trigger.
    """
    n = prev.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    anc = jnp.where(prev >= 0, prev, ids)
    if track == "dist":
        aux = (prev >= 0).astype(jnp.int32)

        def step(state):
            g = state[state[:, 0]]
            new = jnp.stack([g[:, 0], state[:, 1] + g[:, 1]], axis=1)
            # exact convergence test, fused with the round: dist lanes
            # start at 1 except heads (0), so g_dist == 0 everywhere
            # means every ancestor is a head — new == state now and at
            # every later round. Cycles keep g_dist > 0 forever, so a
            # cyclic graph runs all `steps` rounds and the 2^steps
            # detector in _rank_pass still fires.
            return new, jnp.any(g[:, 1] != 0)

    else:
        aux = jnp.minimum(ids, anc)

        def step(state):
            g = state[state[:, 0]]
            new = jnp.stack(
                [g[:, 0], jnp.minimum(state[:, 1], g[:, 1])], axis=1
            )
            # the update is a pure function of state, so one stable
            # round is a fixpoint forever (this pass runs only on the
            # rare cyclic graphs, where the extra full compare is noise)
            return new, jnp.any(new != state)

    def cond(carry):
        i, _, changed = carry
        return (i < steps) & changed

    def body(carry):
        i, state, _ = carry
        new, changed = step(state)
        return i + 1, new, changed

    _, state, changed = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), jnp.stack([anc, aux], axis=1), jnp.bool_(True)),
    )
    return state[:, 0], state[:, 1], changed


def _eq_rows(a: jax.Array, b: jax.Array) -> jax.Array:
    eq = a[:, 0] == b[:, 0]
    for i in range(1, a.shape[1]):
        eq &= a[:, i] == b[:, i]
    return eq


@functools.partial(jax.jit, static_argnames=("k",))
def _build_edges(table: CountTable, k: int):
    """Both-strand sorted edge table: (edge_words [2C, W], covs, valid)."""
    c, w = table.words.shape
    lane = jnp.arange(c, dtype=jnp.int32)
    is_real = lane < table.num_unique
    rc = revcomp_words(table.words, k)
    rc = jnp.where(is_real[:, None], rc, SENTINEL)
    edge_words = jnp.concatenate([table.words, rc], axis=0)
    covs = jnp.concatenate([table.counts, table.counts], axis=0)
    covs = jnp.where(jnp.concatenate([is_real, is_real]), covs, 0)
    edge_words, covs = sort_by_words(edge_words, covs)
    valid = ~_eq_rows(edge_words, jnp.broadcast_to(
        jnp.full((1, w), SENTINEL, jnp.uint32), edge_words.shape
    ))
    return edge_words, covs, valid


@functools.partial(jax.jit, static_argnames=("k",))
def _link_sortjoin(edge_words: jax.Array, valid: jax.Array, k: int):
    """prev[] via one merged sort instead of per-lane binary search.

    The r1 linker ran a bucketed lexicographic bisection (12+ gather
    rounds over the full edge table) plus two extra sorts for in-degrees;
    the join is restructured as a single stable sort of 2E tagged rows — prefix entries (tag 0) and suffix entries
    (tag 1) of every edge — followed by O(E) scans:

      * a key-run's prefix entries all precede its suffix entries, so a
        suffix lane's out-degree = prefix entries in its run, its unique
        successor = the run's first payload, and its in-degree = the run
        length minus the prefix count;
      * edge e chains into that successor iff outdeg == indeg == 1
        (module-doc semantics, bit-identical to the r1 linker);
      * one unique-index scatter writes prev[successor] = e.
    """
    e, w = edge_words.shape
    pre = prefix_node(edge_words, k)
    suf = suffix_node(edge_words, k)
    # The pre/suf tag rides INSIDE the node key's spare low bit instead
    # of its own sort operand: node keys occupy 2(k-1) of the 32W key
    # bits and 2k <= 32W always, so (node << 1) | tag fits, compares
    # identically to (node, tag), and drops the sort from 4 operands to
    # 3 — the link sort is the second-largest bulk sort in the pipeline.
    from .words_jax import shift_left_words, shift_right_words

    pre_p = shift_left_words(pre, 1)
    suf_p = shift_left_words(suf, 1)
    suf_p = suf_p.at[:, -1].set(suf_p[:, -1] | jnp.uint32(1))
    ids = jnp.arange(e, dtype=jnp.int32)
    keys = jnp.concatenate([pre_p, suf_p], axis=0)
    # invalid lanes: pin the packed key to the sentinel (they form one
    # shared run whose outdeg == indeg == #invalid != 1, and are excluded
    # explicitly below as well); a real packed key can never equal the
    # sentinel — its top 32W - 2k + 1 >= 1 bits are zero
    valid2 = jnp.concatenate([valid, valid])
    keys = jnp.where(valid2[:, None], keys, SENTINEL)
    payload = jnp.concatenate([ids, ids])
    ops = jax.lax.sort(
        tuple(keys[:, i] for i in range(w)) + (payload,),
        num_keys=w,
    )
    packed_s = jnp.stack(ops[:w], axis=1)
    pay_s = ops[w]
    sent_rows = _eq_rows(
        packed_s,
        jnp.broadcast_to(
            jnp.full((1, w), SENTINEL, jnp.uint32), packed_s.shape
        ),
    )
    is_pre = (packed_s[:, -1] & jnp.uint32(1)) == 0
    key_s = shift_right_words(packed_s, 1)
    key_s = jnp.where(sent_rows[:, None], SENTINEL, key_s)
    good, succ = join_scan(key_s, is_pre, pay_s)
    # prev[successor] = this suffix lane's edge; indices unique since the
    # successor's node has indeg == 1
    return (
        jnp.full(e, -1, dtype=jnp.int32)
        .at[jnp.where(good, succ, e)]
        .set(pay_s, mode="drop")
    )


def join_scan(key_s: jax.Array, is_pre: jax.Array, pay_s: jax.Array):
    """Shared run-scan core of the tagged successor join.

    Input: [N, W] node keys sorted with prefix entries (is_pre) before
    suffix entries within each key run, plus each entry's edge-id payload.
    Output per lane: good (this suffix lane's node has outdeg == indeg
    == 1 and a prefix entry leads the run) and succ (the run-leading
    prefix entry's edge id; arbitrary where ~good). Used verbatim by the
    single-device linker above and the sharded linker (parallel.compress)
    so the join semantics cannot diverge.

    ``outdeg == 1 and indeg == 1`` means the key run holds EXACTLY two
    entries — one prefix, one suffix, in that order (the tag is a sort
    key) — so every run-leader value a good lane needs sits exactly one
    lane above it. Everything reduces to shift-compares: no prefix
    scans, no random gathers (an earlier formulation spent three
    full-table gathers plus cummax/reversed-cummin/cumsum passes here).
    """
    n2, w = key_s.shape
    prev_key = jnp.concatenate(
        [jnp.full((1, w), SENTINEL, jnp.uint32), key_s[:-1]], axis=0
    )
    same_as_prev = jnp.all(key_s == prev_key, axis=1).at[0].set(False)
    same_as_next = jnp.concatenate([same_as_prev[1:], jnp.zeros(1, bool)])
    pre_above = jnp.concatenate([jnp.zeros(1, bool), is_pre[:-1]])
    sentinel_run = key_s[:, 0] == SENTINEL
    for i in range(1, w):
        sentinel_run &= key_s[:, i] == SENTINEL
    # run of exactly [prefix, suffix]: this suffix lane continues its
    # predecessor's run, the run ends here, and the lane above leads it
    good = (
        ~is_pre
        & pre_above
        & same_as_prev
        & ~same_as_next
        & ~jnp.concatenate([jnp.ones(1, bool), same_as_prev[:-1]])
        & ~sentinel_run
    )
    succ = jnp.concatenate([jnp.zeros(1, pay_s.dtype), pay_s[:-1]])
    return good, succ


def _steps_for(e: int) -> int:
    # dist doubles to exactly 2^steps in cycles; both it and the 1<<steps
    # threshold must fit int32. steps = ceil(log2(e)) + 1 <= 30 requires
    # e <= 2^29 (~6 GB of key words alone — beyond single-chip HBM
    # anyway); the sharded-graph path guards its global ids at the same
    # bound (parallel/compress.py). A clear error, never a silent wrap.
    if e > (1 << 29):
        raise ValueError(
            f"edge table of {e} rows exceeds the int32 pointer-doubling "
            "range (2^29); use the sharded graph path (--sharded-graph)"
        )
    return max(1, int(np.ceil(np.log2(max(e, 2)))) + 1)


@jax.jit
def _rank_pass(prev: jax.Array):
    """One doubling pass: (ancestor, distance, any_cycle).

    In a pure cycle every lane has a predecessor forever, so its distance
    doubles every round and hits exactly 2^steps; chain distances are
    bounded by the chain length < 2^steps. One scalar flag therefore
    detects whether the (rare, circular-genome) cycle-breaking pass is
    needed at all.
    """
    steps = _steps_for(prev.shape[0])
    anc, dist, _ = _doubling(prev, steps, track="dist")
    return anc, dist, jnp.any(dist >= (1 << steps))


@jax.jit
def _break_cycles(prev: jax.Array, valid: jax.Array):
    """Min-id doubling pass; returns prev with each cycle's minimum edge
    turned into a head."""
    e = prev.shape[0]
    ids = jnp.arange(e, dtype=jnp.int32)
    steps = _steps_for(e)
    anc, mn, _ = _doubling(prev, steps, track="min")
    in_cycle = valid & (prev[anc] >= 0)
    return jnp.where(in_cycle & (ids == mn), -1, prev)


@jax.jit
def _finalize_chains(prev: jax.Array, anc: jax.Array, dist: jax.Array, valid: jax.Array):
    heads = valid & (prev == -1)
    head_rank = jnp.cumsum(heads.astype(jnp.int32)) - 1
    uid = jnp.where(valid, head_rank[anc], -1)
    return uid, dist, jnp.sum(heads.astype(jnp.int32))


# Sampled two-level ranking (the fast path of _resolve_chains). Every
# SAMPLE_STRIDE-th edge id becomes a "ruler"; rulers are uniform-random
# along chains because edge ids are lexicographic sort positions,
# unrelated to chain order, so inter-ruler gaps concentrate around
# SAMPLE_STRIDE * ln(E / SAMPLE_STRIDE) << 2^(SAMPLED_MAX_ROUNDS - 1).
SAMPLE_STRIDE = 32
SAMPLED_MAX_ROUNDS = 16
# A straggler-compaction variant of phase A (cap the full-size rounds
# at 6, compact the geometric gap tail, finish it on an E/4 buffer) was
# built and measured slower: finishing the compacted stragglers needs a
# per-round scatter-back into the full state array. Phase A stays plain
# doubling.
# Below this the plain pass is already a few gather-milliseconds and the
# extra host sync + compile of the sampled program costs more than it
# saves. Tests monkeypatch this to 0 to force the fast path on tiny
# graphs.
SAMPLED_MIN_ROWS = 1 << 21

# Contraction tail for phase A of the sampled ranking (GA_RANK_CONTRACT;
# VERDICT r4 item 3). After r rounds of doubling a lane is resolved iff
# its nearest upstream stop is within 2^r, and ruler gaps are ~Geometric
# with mean SAMPLE_STRIDE, so the unresolved fraction decays like
# exp(-2^r / STRIDE): ~14% after 6 rounds, ~2% after 7. Rounds 7..11 of
# the plain pass therefore re-gather an almost-fully-resolved array —
# the contraction variant stops at CONTRACT_R0 full-size rounds,
# sort-compacts the unresolved tail into an E/4 buffer, finishes the
# doubling there (gathers priced by the small array), and recombines
# with ONE unique-index scatter — not the per-round scatter-back that
# was measured off in r3's straggler-compaction probe.
CONTRACT_R0 = 6
# capacity of the compacted tail: e/4 covers the expected ~14% at
# r0=6 with 1.8x headroom; an overflow (pathological ruler luck or a
# huge rulerless cycle) flips ok -> exact fallback, never wrong output
CONTRACT_DIV = 4


@jax.jit
def _rank_sampled(prev: jax.Array):
    """Sampled two-level ranking: (head, rank, ok).

    Plain pointer doubling pays ceil(log2(longest chain)) full-size
    gather rounds — ~24 at E. coli scale. This pass cuts the full-size
    rounds to ceil(log2(max inter-ruler gap)) ~ 10:

      A. cut every ruler into a head (prev' = -1) and pointer-double:
         each lane finds its nearest upstream stop (ruler or real head)
         and the distance to it — gaps are O(STRIDE log E), so this
         converges in few rounds;
      B. contract: link each ruler to the next stop upstream of its
         predecessor, weighted by the phase-A distance, and double over
         the [E/STRIDE] contracted list (negligible rows);
      C. combine: rank = dist-to-stop + contracted rank of the stop; one
         full-size packed-row gather.

    Integer-exact and bit-identical to the plain pass on acyclic graphs
    (same heads, same distances). ``ok`` is False — caller must fall
    back to the exact plain pass — iff phase A hit its round cap (a
    cycle containing no ruler, e.g. a self-loop, or an astronomically
    unlucky gap) or the contracted list still changed at its own cap (a
    cycle threading the rulers). Cycles therefore keep today's exact
    break-at-min-id semantics via the fallback.
    """
    e = prev.shape[0]
    s = SAMPLE_STRIDE
    ids = jnp.arange(e, dtype=jnp.int32)
    is_ruler = (ids % s) == 0
    prev2 = jnp.where(is_ruler, jnp.int32(-1), prev)
    steps_a = min(SAMPLED_MAX_ROUNDS, _steps_for(e))
    anc, dist, changed_a = _doubling(prev2, steps_a, track="dist")
    head, rank, ok_bc = _phases_bc(prev, anc, dist)
    return head, rank, ~changed_a & ok_bc


def _phases_bc(prev: jax.Array, anc: jax.Array, dist: jax.Array):
    """Phases B + C of the sampled ranking, shared by both phase-A
    variants (plain doubling and the contraction tail): contract the
    ruler list, double over it, then combine every lane's stop with its
    stop's contracted rank. ``anc``/``dist`` must map every lane to its
    nearest upstream stop (ruler or real head) with exact distance."""
    e = prev.shape[0]
    s = SAMPLE_STRIDE

    # B: contracted links. Ruler t's predecessor pt chains to stop
    # anc[pt] at distance dist[pt] + 1; a ruler that is a real head is a
    # contracted head (its own stop at distance 0).
    n_r = -(-e // s)
    r_ids = jnp.arange(n_r, dtype=jnp.int32) * s
    pt = prev[r_ids]
    pt_c = jnp.maximum(pt, 0)
    a0 = jnp.where(pt >= 0, anc[pt_c], r_ids)
    d0 = jnp.where(pt >= 0, dist[pt_c] + 1, 0)

    csteps = max(1, int(np.ceil(np.log2(max(n_r, 2)))) + 1)

    def cstep(state):
        canc, cdist = state[:, 0], state[:, 1]
        # a contracted ancestor is gatherable iff it is a ruler; a
        # non-ruler ancestor is a real head — that lane is done
        is_r = (canc % s) == 0
        g = state[jnp.where(is_r, canc // s, 0)]
        new = jnp.stack(
            [
                jnp.where(is_r, g[:, 0], canc),
                jnp.where(is_r, cdist + g[:, 1], cdist),
            ],
            axis=1,
        )
        return new, jnp.any(new != state)

    def ccond(carry):
        i, _, changed = carry
        return (i < csteps) & changed

    def cbody(carry):
        i, state, _ = carry
        new, changed = cstep(state)
        return i + 1, new, changed

    _, cstate, changed_b = jax.lax.while_loop(
        ccond,
        cbody,
        (jnp.int32(0), jnp.stack([a0, d0], axis=1), jnp.bool_(True)),
    )
    # Wrap-free cycle check: a finished contracted lane's ancestor is a
    # real head — a non-ruler, or a ruler with no predecessor. A ruler
    # ancestor that still has a predecessor means a cycle threading the
    # rulers. changed_b alone can miss this: cdist is int32, and on a
    # cycle whose physical length L satisfies v2(L) >= 32 - csteps the
    # doubled distance wraps to 0, so the state reads falsely stable.
    fa = cstate[:, 0]
    cycle_b = jnp.any(((fa % s) == 0) & (prev[fa] >= 0))

    # C: every lane combines its phase-A stop with that stop's
    # contracted rank — one full-size [E] gather of packed [n_r, 2] rows.
    is_r_a = (anc % s) == 0
    g = cstate[jnp.where(is_r_a, anc // s, 0)]
    head = jnp.where(is_r_a, g[:, 0], anc)
    rank = jnp.where(is_r_a, dist + g[:, 1], dist)
    return head, rank, ~changed_b & ~cycle_b


@jax.jit
def _rank_sampled_cyclic(prev: jax.Array):
    """Sampled ranking for graphs WITH cycles (circular chromosomes /
    plasmids): (head, rank, ok, prev_broken).

    The plain sampled pass correctly refuses cycles (phase-B cycle
    detection) and falls back to the exact passes — ~24 full-size
    doubling rounds plus a min-id cycle-breaking pass. This variant resolves ruler-threading cycles at sampled cost:

      A. phase A as usual (rulers cut to stops) — cycle lanes converge
         to their upstream rulers like any other lane;
      D1. per-ruler segment minimum edge id: one (anc, id) sort + run
          leaders + unique-index scatter into ruler slots;
      D2. contracted pointer doubling carrying a running min: after
          ceil(log2(E/s))+1 rounds each cycle ruler has jumped at least
          one full lap, so its min is the cycle's GLOBAL min edge id —
          exactly the lane _break_cycles picks;
      D3. break: prev[cycle min] = -1 per cycle (a masked where);
      E. re-run phases A-C on the broken, now-acyclic graph.

    Bit-identical to _resolve_exact on every graph it accepts (same
    break lane, and head/rank of an acyclic graph are unique). ok=False
    — caller must use the exact fallback — iff a cycle contains NO
    ruler (e.g. a self-loop or a < SAMPLE_STRIDE-edge plasmid with
    unlucky ids): its lanes never resolve in either phase-A pass.
    Callers must finalize against the returned prev_broken (the cycle
    heads exist only there).
    """
    e = prev.shape[0]
    s = SAMPLE_STRIDE
    ids = jnp.arange(e, dtype=jnp.int32)
    is_ruler = (ids % s) == 0
    prev2 = jnp.where(is_ruler, jnp.int32(-1), prev)
    steps_a = min(SAMPLED_MAX_ROUNDS, _steps_for(e))
    anc, dist, changed_a = _doubling(prev2, steps_a, track="dist")

    # D1: segment min. Stable 2-key sort puts each anc-run's smallest id
    # first; run leaders scatter (unique slots) into their ruler's slot.
    n_r = -(-e // s)
    a_s, id_s = jax.lax.sort((anc, ids), num_keys=2)
    leader = jnp.concatenate(
        [jnp.ones(1, bool), a_s[1:] != a_s[:-1]]
    )
    slot = jnp.where(leader & ((a_s % s) == 0), a_s // s, n_r)
    seg_min = (
        jnp.full(n_r + 1, e, jnp.int32).at[slot].set(id_s, mode="drop")[:n_r]
    )

    # contracted ancestor pointer (phase-B prologue, pointer only)
    r_ids = jnp.arange(n_r, dtype=jnp.int32) * s
    pt = prev[r_ids]
    a0 = jnp.where(pt >= 0, anc[jnp.maximum(pt, 0)], r_ids)

    # D2: fixed-round pointer doubling carrying the running min
    csteps = max(1, int(np.ceil(np.log2(max(n_r, 2)))) + 1)

    def dbody(_, state):
        canc, cmin = state[:, 0], state[:, 1]
        is_r = (canc % s) == 0
        g = state[jnp.where(is_r, canc // s, 0)]
        return jnp.stack(
            [
                jnp.where(is_r, g[:, 0], canc),
                jnp.where(is_r, jnp.minimum(cmin, g[:, 1]), cmin),
            ],
            axis=1,
        )

    dstate = jax.lax.fori_loop(
        0, csteps, dbody, jnp.stack([a0, seg_min], axis=1)
    )
    fa = dstate[:, 0]
    # a ruler is ON a cycle iff its final ancestor is a ruler that still
    # has a predecessor (same wrap-free test as phase B's cycle_b)
    is_cyc_r = ((fa % s) == 0) & (prev[fa] >= 0)

    # D3: break each cycle at its global min edge id
    is_r_a = (anc % s) == 0
    slot_a = jnp.where(is_r_a, anc // s, 0)
    lane_cyc = is_r_a & is_cyc_r[slot_a]
    breaks = lane_cyc & (ids == dstate[:, 1][slot_a])
    prev3 = jnp.where(breaks, jnp.int32(-1), prev)

    # E: full sampled pass over the broken graph
    prev2b = jnp.where(is_ruler, jnp.int32(-1), prev3)
    anc2, dist2, changed_a2 = _doubling(prev2b, steps_a, track="dist")
    head, rank, ok_bc = _phases_bc(prev3, anc2, dist2)
    return head, rank, ~changed_a & ~changed_a2 & ok_bc, prev3


@functools.partial(jax.jit, static_argnames=("r0", "div"))
def _rank_sampled_contract(prev: jax.Array, r0: int | None = None,
                           div: int | None = None):
    """Sampled ranking with a sort-compacted contraction tail in phase A
    (GA_RANK_CONTRACT=1; see CONTRACT_R0 above for the cost model).
    r0/div override CONTRACT_R0/CONTRACT_DIV (tests force the
    contraction legs onto tiny graphs with r0=1; production callers use
    the defaults).

    Identical contract to _rank_sampled — (head, rank, ok), integer-
    exact on acyclic graphs, ok=False demands the exact fallback — only
    phase A differs:

      A1. CONTRACT_R0 full-size doubling rounds (early exit unchanged);
          a lane is then resolved iff its ancestor is a stop, i.e. the
          ancestor's own dist is 0 (stops never accumulate distance).
      A2. unresolved lanes sort-compact (stable single-key sort on the
          resolved flag — kept lanes stay in id order) into a static
          E/CONTRACT_DIV buffer with their (id, target, dist).
      A3. each compacted lane finishes against its target: a resolved
          target supplies its final (stop, dist) directly; an
          unresolved target is remapped into compacted space (the
          cumsum of the unresolved mask — compaction order IS id
          order), where doubling continues on the small array with
          done-lanes tagged by bitwise-not stop ids (the phase-B
          encoding trick).
      A4. recombine: ONE unique-index scatter of the compacted rows'
          (stop, dist) back into the full arrays — unique ids by
          construction, so this is the same primitive as the linker's
          prev[successor] write, not the per-round scatter-back that
          r3 measured off.
    """
    e = prev.shape[0]
    s = SAMPLE_STRIDE
    ids = jnp.arange(e, dtype=jnp.int32)
    is_ruler = (ids % s) == 0
    prev2 = jnp.where(is_ruler, jnp.int32(-1), prev)
    r0 = min(r0 or CONTRACT_R0, _steps_for(e))
    anc, dist, changed_a = _doubling(prev2, r0, track="dist")

    # A2: resolved iff the ancestor is a stop (dist[stop] stays 0;
    # every non-stop lane has dist >= 1 from round 1 on)
    resolved = dist[anc] == 0
    unres = ~resolved
    n_un = jnp.sum(unres.astype(jnp.int32))
    e4 = min(e, max(128, -(-e // (div or CONTRACT_DIV) // 128) * 128))
    over = n_un > e4
    out = jax.lax.sort(
        (resolved.astype(jnp.uint32), ids, anc, dist), num_keys=1
    )
    o_id = out[1][:e4]
    o_t = out[2][:e4]
    o_dist = out[3][:e4]
    lane4 = jnp.arange(e4, dtype=jnp.int32)
    valid_a = lane4 < n_un

    # A3: finish against the target
    nidx = jnp.cumsum(unres.astype(jnp.int32)) - 1
    t_res = resolved[o_t]
    head_t = anc[o_t]
    add_t = dist[o_t]
    a_anc = jnp.where(
        valid_a & ~t_res,
        nidx[o_t],
        ~jnp.where(valid_a & t_res, head_t, 0),
    )
    a_dist = jnp.where(
        valid_a, o_dist + jnp.where(t_res, add_t, 0), 0
    )

    def astep(state):
        aanc, adist = state[:, 0], state[:, 1]
        live = aanc >= 0
        g = state[jnp.where(live, aanc, 0)]
        new = jnp.stack(
            [
                jnp.where(live, g[:, 0], aanc),
                jnp.where(live, adist + g[:, 1], adist),
            ],
            axis=1,
        )
        return new, jnp.any(new != state)

    def acond(carry):
        i, _, changed = carry
        return (i < SAMPLED_MAX_ROUNDS) & changed

    def abody(carry):
        i, state, _ = carry
        new, changed = astep(state)
        return i + 1, new, changed

    _, astate, _ = jax.lax.while_loop(
        acond,
        abody,
        (jnp.int32(0), jnp.stack([a_anc, a_dist], axis=1), jnp.bool_(True)),
    )
    # every valid compacted lane must have finished (negative-tagged
    # stop); a live lane at the round cap is a rulerless cycle —
    # exact-fallback territory, same as changed_a in the plain pass
    live_left = jnp.any(valid_a & (astate[:, 0] >= 0))

    # A4: one unique-index scatter back into the full-size arrays
    a_head = ~astate[:, 0]
    scat = jnp.where(valid_a, o_id, e)
    anc_f = anc.at[scat].set(a_head, mode="drop")
    dist_f = dist.at[scat].set(astate[:, 1], mode="drop")

    head, rank, ok_bc = _phases_bc(prev, anc_f, dist_f)
    # changed_a needs no term of its own: if phase A already converged
    # the contraction legs were no-ops (n_un == 0), and if it didn't the
    # tail either finished (live_left False) or demands the fallback
    return head, rank, ~over & ~live_left & ok_bc


def _use_contract() -> bool:
    import os

    return os.environ.get("GA_RANK_CONTRACT", "0") == "1"


def _resolve_chains(prev: jax.Array, valid: jax.Array):
    """Chain heads/offsets by pointer doubling; large tables take the
    sampled two-level fast path. Cycles (circular chromosomes) first try
    the cycle-aware sampled pass (_rank_sampled_cyclic, same break-at-
    min-id semantics at ~2x sampled cost); only rulerless cycles reach
    the exact fallback's adaptive cycle-breaking."""
    if prev.shape[0] >= SAMPLED_MIN_ROWS:
        rank_fn = (
            _rank_sampled_contract if _use_contract() else _rank_sampled
        )
        head, rank, ok = rank_fn(prev)
        if bool(ok):
            return _finalize_chains(prev, head, rank, valid)
        head, rank, ok, prev3 = _rank_sampled_cyclic(prev)
        if bool(ok):
            return _finalize_chains(prev3, head, rank, valid)
    return _resolve_exact(prev, valid)


def _resolve_exact(prev: jax.Array, valid: jax.Array):
    """Exact path: plain doubling + adaptive cycle break + finalize."""
    anc, dist, has_cycle = _rank_pass(prev)
    if bool(has_cycle):
        prev = _break_cycles(prev, valid)
        anc, dist, _ = _rank_pass(prev)
    return _finalize_chains(prev, anc, dist, valid)


@functools.partial(jax.jit, static_argnames=("k", "contract"))
def _compress_fused_sampled(table: CountTable, k: int, contract: bool = False):
    """Build + link + sampled rank + finalize, ONE dispatch.

    jit-of-jit inlines, so the whole acyclic fast path is one program:
    no dispatch gaps between stages and no host bool() sync, with zero
    semantic change. `ok` False (cycle / unlucky ruler gap)
    falls back to the exact passes, same as _resolve_chains. contract
    selects the sort-compacted phase-A tail (GA_RANK_CONTRACT).
    """
    edge_words, covs, valid = _build_edges(table, k)
    prev = _link_sortjoin(edge_words, valid, k)
    rank_fn = _rank_sampled_contract if contract else _rank_sampled
    head, rank, ok = rank_fn(prev)
    uid, pos, num = _finalize_chains(prev, head, rank, valid)
    return edge_words, covs, valid, prev, uid, pos, num, ok


@functools.partial(jax.jit, static_argnames=("k",))
def _compress_fused_exact(table: CountTable, k: int):
    """Build + link + plain rank + finalize, one dispatch (small tables,
    below SAMPLED_MIN_ROWS). has_cycle True triggers the host-driven
    cycle-break rerun, identical to _resolve_exact."""
    edge_words, covs, valid = _build_edges(table, k)
    prev = _link_sortjoin(edge_words, valid, k)
    anc, dist, has_cycle = _rank_pass(prev)
    uid, pos, num = _finalize_chains(prev, anc, dist, valid)
    return edge_words, covs, valid, prev, uid, pos, num, has_cycle


class SpellArrays(NamedTuple):
    """Compact spelling transfer set (only these arrays cross to the
    host; the full edge table never does).

    bases:     [ceil(E/4)] uint8 — last base of every edge, sorted by
               (uid, pos): the concatenation of all unitig bodies in
               unitig order, packed 4 bases/byte (utils.dna.pack_codes
               bit layout) — packing quarters the device->host copy. Unpack via utils.dna.unpack_codes_np.
    head_words:[U_cap, W] uint32 — the head edge k-mer of each unitig
               (its prefix spells the unitig's first k-1 bases).
    lengths:   [U_cap] int32 edge counts per unitig (0 = padding).
    cov_sum:   [U_cap] int32 summed edge multiplicities per unitig.
    num_unitigs: scalar int32.
    overflow:  scalar bool — num_unitigs exceeded U_cap; caller must retry
               with a larger cap (checked, never silent).
    """

    bases: jax.Array
    head_words: jax.Array
    lengths: jax.Array
    cov_sum: jax.Array
    num_unitigs: jax.Array
    overflow: jax.Array


@functools.partial(jax.jit, static_argnames=("u_cap",))
def spell_arrays(dev: DeviceUnitigs, u_cap: int) -> SpellArrays:
    """Reduce DeviceUnitigs to the compact transfer set (see SpellArrays).

    One sort puts every edge in (uid, pos) order — pos packs its 2-bit last
    base so a single uint32 operand carries both — with the edge words and
    coverage as payload; segment scans then produce per-unitig lengths and
    coverage sums, and a second (tiny-key) sort compacts the per-unitig
    rows to the front for a static [u_cap] slice.
    """
    e, w = dev.edge_words.shape
    big = jnp.int32(2**30)
    uid_adj = jnp.where(dev.valid, dev.uid, big).astype(jnp.uint32)
    packed = (
        (dev.pos.astype(jnp.uint32) << jnp.uint32(2))
        | (dev.edge_words[:, -1] & jnp.uint32(3))
    )
    operands = (uid_adj, packed, dev.cov) + tuple(
        dev.edge_words[:, i] for i in range(w)
    )
    out = jax.lax.sort(operands, num_keys=2)
    uid_s, packed_s, cov_s = out[0], out[1], out[2]
    words_s = jnp.stack(out[3 : 3 + w], axis=1)
    bases = (packed_s & jnp.uint32(3)).astype(jnp.uint8)
    # pack 4 bases/byte for the device->host pull (E is static;
    # rows past the valid body are garbage the host never unpacks)
    e4 = -(-e // 4) * 4
    quads = jnp.concatenate(
        [bases, jnp.zeros(e4 - e, jnp.uint8)]
    ).reshape(-1, 4)
    bases_packed = (
        quads[:, 0]
        | (quads[:, 1] << 2)
        | (quads[:, 2] << 4)
        | (quads[:, 3] << 6)
    )

    idx = jnp.arange(e, dtype=jnp.int32)
    prev_uid = jnp.concatenate([jnp.full((1,), 0xFFFFFFFF, jnp.uint32), uid_s[:-1]])
    run_start = (uid_s != prev_uid).at[0].set(True)
    valid_lane = uid_s != jnp.uint32(2**30)
    is_start = run_start & valid_lane
    num = jnp.sum(is_start.astype(jnp.int32))
    e_valid = jnp.sum(valid_lane.astype(jnp.int32))
    # lengths and coverage sums by neighbor-diff of (position, exclusive
    # cov cumsum) carried through the compaction sort — no reversed-cummin
    # scan, no boundary gather (same trick as count_jax._segment_reduce);
    # keeping the invalid run's first row puts the valid totals right
    # after the last real unitig's row
    excl_cov = jnp.cumsum(cov_s) - cov_s
    total_cov = jnp.sum(jnp.where(valid_lane, cov_s, 0))

    # compact per-unitig rows (at start lanes, already in uid order) to the
    # front: sort by the tiny run_start key, stable in uid order
    sort2 = jax.lax.sort(
        ((~run_start).astype(jnp.uint32), uid_s, idx, excl_cov)
        + tuple(words_s[:, i] for i in range(w)),
        num_keys=2,
    )
    pos_c = sort2[2][:u_cap]
    excl_c = sort2[3][:u_cap]
    out_idx = jnp.arange(u_cap, dtype=jnp.int32)
    nxt_pos = jnp.concatenate([pos_c[1:], jnp.zeros(1, jnp.int32)])
    nxt_pos = jnp.where(out_idx == num - 1, e_valid, nxt_pos)
    nxt_cov = jnp.concatenate([excl_c[1:], jnp.zeros(1, excl_c.dtype)])
    nxt_cov = jnp.where(out_idx == num - 1, total_cov, nxt_cov)
    lengths_c = jnp.where(out_idx < num, nxt_pos - pos_c, 0)
    cov_sum_c = jnp.where(out_idx < num, nxt_cov - excl_c, 0)
    head_words = jnp.stack([sort2[4 + i][:u_cap] for i in range(w)], axis=1)
    return SpellArrays(
        bases=bases_packed,
        head_words=head_words,
        lengths=lengths_c,
        cov_sum=cov_sum_c,
        num_unitigs=num,
        overflow=num > u_cap,
    )


def compress_unitigs_device(table: CountTable, k: int) -> DeviceUnitigs:
    """Filtered canonical CountTable -> unitig chain assignment (see module).

    Requires odd k (no palindromic k-mers, so the both-strand edge set has
    exactly two distinct directed edges per canonical k-mer). The common
    acyclic case runs as ONE fused dispatch (build + link + rank +
    finalize). Cycles / sampled-pass misses fall back to the exact
    host-driven passes, bit-identically.
    """
    if k % 2 == 0:
        raise ValueError("device unitig compression requires odd k")
    if 2 * table.words.shape[0] >= (1 << 29):
        # _rank_pass carries chain distances in int32; beyond 2^29 edges the
        # doubled distance / cycle threshold would overflow (ADVICE.md r1).
        # 2^29 edge rows is ~4 GiB of key words alone — shard the table
        # instead.
        raise ValueError(
            "edge table too large for device compression "
            f"({2 * table.words.shape[0]} rows >= 2^29); "
            "reduce table capacity or use the distributed path"
        )
    if 2 * table.words.shape[0] >= SAMPLED_MIN_ROWS:
        (
            edge_words, covs, valid, prev, uid, pos, num, ok,
        ) = _compress_fused_sampled(table, k, contract=_use_contract())
        if not bool(ok):
            # cycles: the cycle-aware sampled pass first (break at each
            # cycle's min edge id, ~2x sampled cost); rulerless cycles /
            # over-cap ruler gaps reach the exact fallback
            head, rank, ok2, prev3 = _rank_sampled_cyclic(prev)
            if bool(ok2):
                uid, pos, num = _finalize_chains(prev3, head, rank, valid)
            else:
                uid, pos, num = _resolve_exact(prev, valid)
    else:
        (
            edge_words, covs, valid, prev, uid, pos, num, has_cycle,
        ) = _compress_fused_exact(table, k)
        if bool(has_cycle):
            prev2 = _break_cycles(prev, valid)
            anc, dist, _ = _rank_pass(prev2)
            uid, pos, num = _finalize_chains(prev2, anc, dist, valid)
    return DeviceUnitigs(
        edge_words=edge_words,
        cov=covs,
        uid=uid,
        pos=pos,
        valid=valid,
        num_unitigs=num,
    )
