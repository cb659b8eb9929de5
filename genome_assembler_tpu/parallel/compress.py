"""Sharded unitig compression: the graph never gathers onto one device.

VERDICT r1 item 6 / SURVEY.md §5 long-context row: the r1 distributed path
counted shard-wise but then gathered every shard to one device for
compression, bounding graph size by a single device's memory. Here every
compression stage stays sharded over the mesh; per-device memory is a set
of static [K]-row buffers with K = edges/device, so capacity scales ~1/D
(see ``peak_rows_per_device`` — shapes are static, so the scaling claim is
shape arithmetic, and tests pin it).

Layout: device d owns edge rows with global ids [d*K, (d+1)*K); owner and
slot of any id are one divide/mod — no directory. Stages, all under one
``shard_map``:

  1. local both-strand edge build + local sort (zero comms);
  2. successor linking: every edge emits (prefix-node, id) and
     (suffix-node, id) records, all-to-all'd to the node's hash owner;
     each owner runs the r1 sort-join (ops.unitig_jax._link_sortjoin
     semantics) on its received records and routes prev-pointers back to
     the predecessor's owner;
  3. ranking over global ids: the sampled two-level fast path (mirrors
     ops.unitig_jax._rank_sampled) pointer-doubles only to the nearest
     ruler — each round deduplicates local ancestor targets (sort +
     scans), all-to-alls the unique queries to their owners, answers
     with a local row gather, and all-to-alls back — then all-gathers
     the E/STRIDE contracted list once and ranks it locally with zero
     per-round communication; rounds stop early on a pmax-replicated
     convergence flag, so the interconnect pays ceil(log2(max ruler
     gap)) query rounds, not ceil(log2(global E));
  4. unitig numbering: head counts all-gather into global offsets; one
     more query round fetches uid(anc) for every edge;
  5. spelling: each device emits fixed-size per-edge quads
     (uid, pos, base, cov) + head rows; the host assembles strings with
     NumPy (host RAM, not HBM, is the only O(E) consumer).

Cycle handling matches the single-device path bit for bit: the sampled
pass detects non-convergence (a cycle, or a ruler gap past the round cap)
and falls back to the exact pass — full doubling, distance-overflow cycle
detection, a min-id pass breaking each cycle at its smallest GLOBAL edge
id, and a rerun of the distance pass.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.count_jax import CountTable, compact_front, sort_by_words
from ..ops.hash import mix_words
from ..ops.kmer_jax import SENTINEL
from ..ops.unitig_jax import SAMPLE_STRIDE, SAMPLED_MAX_ROUNDS
from ..ops.words_jax import (
    prefix_node,
    revcomp_words,
    shift_left_words,
    shift_right_words,
    suffix_node,
)
from ..utils.dna import key_words
from .mesh import axis_size, mesh_axes

# +inf for int32 id lanes (sorts last). A plain Python int, NOT a jnp
# scalar: a module-level jnp constant gets its aval bound to whichever
# shard_map mesh traces it first and then poisons traces under any other
# mesh ("context mesh should match the aval mesh").
BIG = 2**30


def _eq_rows(a, b):
    eq = a[:, 0] == b[:, 0]
    for i in range(1, a.shape[1]):
        eq &= a[:, i] == b[:, i]
    return eq


def _bucket_pack(values, owner, valid, d, cap):
    """Pack rows into a [d, cap, ...] send buffer by owner bucket.

    values: [N, C] int32 (C columns packed together); owner: [N] int32;
    scatter-free: sort by (invalid, owner) and gather contiguous runs.
    Returns (send [d, cap, C], overflow).
    """
    n, c = values.shape
    inv = (~valid).astype(jnp.uint32)
    ops = jax.lax.sort(
        (inv, owner.astype(jnp.uint32))
        + tuple(values[:, i] for i in range(c)),
        num_keys=2,
    )
    owner_sorted = ops[1]
    vals_sorted = jnp.stack(ops[2:], axis=1)
    valid_sorted = ops[0] == 0
    owner_or_inf = jnp.where(valid_sorted, owner_sorted, jnp.uint32(d))
    ids = jnp.arange(d, dtype=jnp.uint32)
    starts = jnp.searchsorted(owner_or_inf, ids, side="left")
    ends = jnp.searchsorted(owner_or_inf, ids, side="right")
    per = (ends - starts).astype(jnp.int32)
    slot = jnp.arange(cap, dtype=jnp.int32)
    src = jnp.clip(starts.astype(jnp.int32)[:, None] + slot[None, :], 0, n - 1)
    in_run = slot[None, :] < per[:, None]
    send = vals_sorted[src.reshape(-1)].reshape(d, cap, c)
    # pad with -1: as uint32 key words that is the sentinel (whose run the
    # join already excludes), as an id lane it fails every (x >= 0) check
    send = jnp.where(in_run[..., None], send, -1)
    return send, jnp.any(per > cap)


def _join_cap(k_cap: int, d: int) -> int:
    """Per-owner rows of the successor-join routing buffer: expected
    2*k_cap/D with hash-skew slack. ONE definition — peak_rows_per_device
    (and its memory-scaling tests) must track the real buffer shape."""
    return int(2 * k_cap / d * 1.6) + 128


def comm_bytes_estimate(
    d: int, k: int, c_shard: int, u_block: int | None = None
) -> dict[str, int]:
    """Static all-to-all volume of the sharded compression stages, in bytes
    summed across all devices (SURVEY.md §5 metrics row: "all-to-all
    volume"). Send buffers are static shapes, so the per-dispatch volume
    is exact; the doubling loop's round count is data-dependent with early
    exit, so its total is reported as per-round bytes + the round cap.
    """
    w = key_words(k)
    k_cap = 2 * c_shard
    cap_join = _join_cap(k_cap, d)
    cap_pair = int(k_cap / d * 1.6) + 128
    cap_query = int(k_cap / d * 2.0) + 128
    cap_route = min(k_cap, int(k_cap / d * 2.0) + 128)  # route_slack=2.0
    ub = u_block if u_block is not None else cap_route
    return {
        # linking: (node<<1|tag, gid) records to node owners +
        # prev-pointer pairs back to the successor's owner (the pre/suf
        # tag rides the node key's spare low bit: w+1 columns, not w+2)
        "link": d * d * (cap_join * (w + 1) + cap_pair * 2) * 4,
        # one doubling/uid query round: id queries out, [anc, aux] back
        "query_round": d * d * cap_query * 3 * 4,
        "query_rounds_max": max(
            1, int(math.ceil(math.log2(max(d * k_cap, 2)))) + 1
        ),
        # spelling: per-unitig stats to numbering owners + base routing
        "spell": d * d * (ub * 3 + cap_route) * 4,
    }


def _answer_queries(state, recv, k_cap):
    """Owner side of a query round: state rows for received global ids."""
    slot = jnp.clip(recv % k_cap, 0, k_cap - 1)
    ans = state[slot.reshape(-1)].reshape(recv.shape + (state.shape[-1],))
    return jnp.where((recv >= 0)[..., None] & (recv < BIG)[..., None], ans, -1)


def make_sharded_compress(
    mesh: Mesh, k: int, c_shard: int, axis=None
):
    """Build the jitted sharded compression step.

    Input: per-device filtered table shards as global row-sharded arrays
    (words [D*C, W], counts [D*C]). Output (all row-sharded [D*K] with
    K = 2*C): valid, uid, pos, cov, last base, is_head flag, plus
    head_words for spelling. Everything static-shape; routing overflows
    are flagged, never silent.
    """
    axis = axis if axis is not None else mesh_axes(mesh)
    d = axis_size(mesh, axis)
    w = key_words(k)
    k_cap = 2 * c_shard  # per-device directed-edge capacity
    if d * k_cap >= (1 << 29):
        raise ValueError("global edge table exceeds int32 doubling range")
    # per-owner caps (expected/D with slack; overflow-checked)
    cap_join = _join_cap(k_cap, d)
    cap_pair = int(k_cap / d * 1.6) + 128
    cap_query = int(k_cap / d * 2.0) + 128
    steps = max(1, int(math.ceil(math.log2(max(d * k_cap, 2)))) + 1)

    def owner_of(gid):
        return (gid // k_cap).astype(jnp.uint32)

    def local_edges(words, counts):
        """Both-strand local edge table, locally sorted."""
        is_real = ~_eq_rows(words, jnp.broadcast_to(
            jnp.full((1, w), SENTINEL, jnp.uint32), words.shape))
        rc = revcomp_words(words, k)
        rc = jnp.where(is_real[:, None], rc, SENTINEL)
        edge_words = jnp.concatenate([words, rc], axis=0)
        covs = jnp.concatenate([counts, counts], axis=0)
        covs = jnp.where(jnp.concatenate([is_real, is_real]), covs, 0)
        edge_words, covs = sort_by_words(edge_words, covs)
        valid = ~_eq_rows(edge_words, jnp.broadcast_to(
            jnp.full((1, w), SENTINEL, jnp.uint32), edge_words.shape))
        return edge_words, covs, valid

    def link(edge_words, valid, my_gid):
        """prev[K] (global ids, -1 none) via node-owner all-to-all join."""
        pre = prefix_node(edge_words, k)
        suf = suffix_node(edge_words, k)
        # records: (node key << 1 | pre/suf tag) + global edge id — the
        # tag rides the node key's spare low bit (2k <= 32W always), so
        # the a2a record is w+1 int32 columns instead of w+2 (25% less
        # link wire volume at w=2) and the receive sort drops an operand
        # (same packing as the single-device linker, ops.unitig_jax)
        pre_p = shift_left_words(pre, 1)
        suf_p = shift_left_words(suf, 1)
        suf_p = suf_p.at[:, -1].set(suf_p[:, -1] | jnp.uint32(1))
        keys = jnp.concatenate([pre_p, suf_p], axis=0)
        rec_valid = jnp.concatenate([valid, valid])
        keys = jnp.where(rec_valid[:, None], keys, SENTINEL)
        gid2 = jnp.concatenate([my_gid, my_gid])
        # owner must be a function of the NODE key alone (both tags of a
        # node meet at one owner): hash the tag-stripped key. The hash is
        # SALTED to decorrelate it from the kmer->shard routing hash:
        # suf(K) differs from K only in w0's top two bits (verbatim when
        # the dropped base is A), and mix_words' finalizer does not fully
        # avalanche a top-2-bit difference into the low owner bits —
        # unsalted, P(owner(suf(K)) == home(K)) measured 0.51 instead of
        # 1/d, a 2x diagonal load on the join buckets that overflowed
        # cap_join at CFG-4 3 Mb scale (r4). Xoring a constant into every
        # word picks an independent member of the hash family, so node
        # owners are uniform regardless of node-vs-kmer word collisions.
        node_key = jnp.concatenate([pre, suf], axis=0)
        node_key = jnp.where(rec_valid[:, None], node_key, SENTINEL)
        node_owner = (
            mix_words(node_key ^ jnp.uint32(0x5BD1E995)) % jnp.uint32(d)
        ).astype(jnp.int32)
        rec = jnp.concatenate(
            [keys.astype(jnp.int32), gid2[:, None]], axis=1
        )
        send, ovf1 = _bucket_pack(
            rec, node_owner, rec_valid, d, cap_join
        )
        recv = jax.lax.all_to_all(
            send, axis, split_axis=0, concat_axis=0, tiled=False
        ).reshape(d * cap_join, w + 1)

        # sort received records by the packed (node key, tag); padded
        # lanes carry the sentinel key (see _bucket_pack) and their run
        # is excluded by the shared join core
        from ..ops.unitig_jax import join_scan

        rkeys = recv[:, :w].astype(jnp.uint32)
        rgid = recv[:, w]
        ops = jax.lax.sort(
            tuple(rkeys[:, i] for i in range(w)) + (rgid,),
            num_keys=w,
        )
        packed_s = jnp.stack(ops[:w], axis=1)
        pay = ops[w]
        sent_rows = _eq_rows(
            packed_s,
            jnp.broadcast_to(
                jnp.full((1, w), SENTINEL, jnp.uint32), packed_s.shape
            ),
        )
        is_pre = (packed_s[:, -1] & jnp.uint32(1)) == 0
        key_s = shift_right_words(packed_s, 1)
        key_s = jnp.where(sent_rows[:, None], SENTINEL, key_s)
        good, succ = join_scan(key_s, is_pre, pay)
        # pair (successor gid, predecessor gid) -> successor's owner
        pair = jnp.stack([succ, pay], axis=1)
        send2, ovf2 = _bucket_pack(pair, owner_of(succ).astype(jnp.int32), good, d, cap_pair)
        recv2 = jax.lax.all_to_all(
            send2, axis, split_axis=0, concat_axis=0, tiled=False
        ).reshape(d * cap_pair, 2)
        tgt = recv2[:, 0]
        ok = (tgt >= 0) & (tgt < BIG)
        slot = jnp.where(ok, tgt % k_cap, k_cap)
        prev = (
            jnp.full(k_cap, -1, jnp.int32)
            .at[slot]
            .set(jnp.where(ok, recv2[:, 1], -1), mode="drop")
        )
        return prev, ovf1, ovf2

    def query_round(state, targets_needed, valid):
        """Fetch state rows for per-lane global-id targets (deduplicated).

        Returns ([K, S] answers aligned to input lanes, overflow).
        """
        n = targets_needed.shape[0]
        lane = jnp.arange(n, dtype=jnp.int32)
        t = jnp.where(valid, targets_needed, BIG)
        # dedupe: sort targets (carrying lane), rank runs
        ts, lane_s = jax.lax.sort((t, lane), num_keys=1)
        new = jnp.concatenate(
            [jnp.ones(1, bool), ts[1:] != ts[:-1]]
        )
        uniq_rank_sorted = jnp.cumsum(new.astype(jnp.int32)) - 1
        # unique targets compacted to front (still ascending)
        uniq_t = jnp.where(new, ts, BIG)
        (uniq_t,) = jax.lax.sort((uniq_t,), num_keys=1)
        # per-lane unique rank, restored to lane order
        _, uniq_rank = jax.lax.sort((lane_s, uniq_rank_sorted), num_keys=1)

        # owner ranges over the sorted unique targets
        uniq_owner = jnp.where(
            uniq_t < BIG, (uniq_t // k_cap).astype(jnp.uint32), jnp.uint32(d)
        )
        ids = jnp.arange(d, dtype=jnp.uint32)
        starts = jnp.searchsorted(uniq_owner, ids, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(uniq_owner, ids, side="right").astype(jnp.int32)
        per = ends - starts
        ovf = jnp.any(per > cap_query)
        slot = jnp.arange(cap_query, dtype=jnp.int32)
        src = jnp.clip(starts[:, None] + slot[None, :], 0, n - 1)
        in_run = slot[None, :] < per[:, None]
        send = jnp.where(in_run, uniq_t[src.reshape(-1)].reshape(d, cap_query), BIG)

        recv = jax.lax.all_to_all(
            send[..., None], axis, split_axis=0, concat_axis=0, tiled=False
        )[..., 0]
        ans = _answer_queries(state, recv, k_cap)
        resp = jax.lax.all_to_all(
            ans, axis, split_axis=0, concat_axis=0, tiled=False
        )  # [d, cap_query, S]: my bucket-b unique answers

        # unique i -> (owner o, slot i - starts[o]) -> flat resp index
        o = jnp.clip(uniq_owner.astype(jnp.int32), 0, d - 1)
        flat = o * cap_query + jnp.clip(
            jnp.arange(n, dtype=jnp.int32) - starts[o], 0, cap_query - 1
        )
        ans_uniq = resp.reshape(d * cap_query, -1)[flat]
        return ans_uniq[uniq_rank], ovf

    def double(prev, valid, track, max_rounds=None):
        """Distributed pointer doubling; returns (anc, aux, changed, ovf).

        Early exit mirrors the single-device pass: the loop stops once a
        round changes nothing anywhere (pmax-replicated flag), so rounds
        paid = ceil(log2(longest chain)), not ceil(log2(global E)); each
        round here costs sorts + three all_to_alls, so the saving rides
        the interconnect. ``changed`` True on exit means the round cap
        was exhausted before a fixpoint (cycles, or a sampled pass whose
        cap was too small) — callers use it for cycle detection and for
        the sampled fast path's exact-fallback trigger.
        """
        rounds = steps if max_rounds is None else max_rounds
        my_gid = (
            jax.lax.axis_index(axis).astype(jnp.int32) * k_cap
            + jnp.arange(k_cap, dtype=jnp.int32)
        )
        anc = jnp.where(prev >= 0, prev, my_gid)
        if track == "dist":
            aux = (prev >= 0).astype(jnp.int32)
        else:
            aux = jnp.minimum(my_gid, anc)
        state = jnp.stack([anc, aux], axis=1)

        def cond(carry):
            i, _, changed, _ = carry
            return (i < rounds) & changed

        def body(carry):
            i, state, _, ovf = carry
            ans, o = query_round(state, state[:, 0], valid)
            anc2 = jnp.where(valid, ans[:, 0], state[:, 0])
            if track == "dist":
                aux2 = jnp.where(valid, state[:, 1] + ans[:, 1], state[:, 1])
                # all fetched increments 0 => every ancestor is a head,
                # now and at every later round (cycles keep them > 0)
                local_changed = jnp.any(valid & (ans[:, 1] != 0))
            else:
                aux2 = jnp.where(
                    valid, jnp.minimum(state[:, 1], ans[:, 1]), state[:, 1]
                )
                local_changed = jnp.any(
                    valid & ((anc2 != state[:, 0]) | (aux2 != state[:, 1]))
                )
            changed = (
                jax.lax.pmax(local_changed.astype(jnp.int32), axis) > 0
            )
            return i + 1, jnp.stack([anc2, aux2], axis=1), changed, ovf | o

        _, state, changed, ovf = jax.lax.while_loop(
            cond,
            body,
            (jnp.int32(0), state, jnp.asarray(True), jnp.asarray(False)),
        )
        return state[:, 0], state[:, 1], changed, ovf

    # Sampled two-level ranking (mirrors ops.unitig_jax._rank_sampled,
    # distributed): every SAMPLE_STRIDE-th global id is a ruler. Phase A
    # needs only ceil(log2(max inter-ruler gap)) query rounds instead of
    # ceil(log2(global E)); the contracted list (E / STRIDE rows) is
    # all-gathered and ranked LOCALLY on every device — zero per-round
    # communication for phase B. k_cap is a snug-grid multiple of the
    # stride, so (gid % STRIDE == 0) identifies rulers in global id space.
    s_stride = SAMPLE_STRIDE
    sampled_rounds = min(SAMPLED_MAX_ROUNDS, steps)
    use_sampled = k_cap % s_stride == 0 and k_cap >= 4 * s_stride

    def crow_of(gid):
        return (gid // k_cap) * (k_cap // s_stride) + (gid % k_cap) // s_stride

    def rank_sampled(prev, valid, my_gid):
        """(head, rank, ok, ovf) — ok False requires the exact fallback."""
        is_ruler = (my_gid % s_stride) == 0
        prev2 = jnp.where(is_ruler, jnp.int32(-1), prev)
        anc, dist, changed_a, o_a = double(
            prev2, valid, "dist", max_rounds=sampled_rounds
        )

        # contracted links: ruler t -> nearest stop above prev[t],
        # weighted by the phase-A distance (+1 for the t -> prev[t] edge)
        r_slots = jnp.arange(0, k_cap, s_stride, dtype=jnp.int32)
        r_gid = my_gid[r_slots]
        pt = prev[r_slots]
        pans, o_b = query_round(
            jnp.stack([anc, dist], axis=1), pt, pt >= 0
        )
        a0 = jnp.where(pt >= 0, pans[:, 0], r_gid)
        d0 = jnp.where(pt >= 0, pans[:, 1] + 1, 0)
        cstate_local = jnp.stack([a0, d0], axis=1)
        # replicate the contracted list; rank it locally on every device
        cstate = jax.lax.all_gather(cstate_local, axis).reshape(-1, 2)
        cstate0 = cstate  # pre-loop state: d0 == 0 iff contracted head
        n_c = cstate.shape[0]
        csteps = max(1, int(math.ceil(math.log2(max(n_c, 2)))) + 1)

        def ccond(carry):
            i, _, changed = carry
            return (i < csteps) & changed

        def cbody(carry):
            i, state, _ = carry
            canc, cdist = state[:, 0], state[:, 1]
            is_r = (canc % s_stride) == 0
            g = state[jnp.where(is_r, crow_of(canc), 0)]
            new = jnp.stack(
                [
                    jnp.where(is_r, g[:, 0], canc),
                    jnp.where(is_r, cdist + g[:, 1], cdist),
                ],
                axis=1,
            )
            return i + 1, new, jnp.any(new != state)

        _, cstate, changed_b = jax.lax.while_loop(
            ccond,
            cbody,
            (jnp.int32(0), cstate, jnp.asarray(True)),
        )
        # Wrap-free cycle check (mirrors ops.unitig_jax._rank_sampled): a
        # finished lane's final ancestor is a non-ruler real head or a
        # contracted head (initial distance 0 ⇔ no predecessor). A ruler
        # ancestor that is not a contracted head means a cycle threading
        # the rulers — changed_b alone can miss it when the int32 doubled
        # distance wraps to 0 (cycle length divisible by a large power of
        # two). cstate0 is replicated, so the check costs no communication.
        fa = cstate[:, 0]
        fa_is_ruler = (fa % s_stride) == 0
        anc_is_chead = cstate0[jnp.where(fa_is_ruler, crow_of(fa), 0), 1] == 0
        cycle_b = jnp.any(fa_is_ruler & ~anc_is_chead)

        is_r_a = (anc % s_stride) == 0
        g = cstate[jnp.where(is_r_a, crow_of(anc), 0)]
        head = jnp.where(is_r_a, g[:, 0], anc)
        rank = jnp.where(is_r_a, dist + g[:, 1], dist)
        ok = ~changed_a & ~changed_b & ~cycle_b
        return head, rank, ok, o_a | o_b

    def step(words_sh, counts_sh):
        words = words_sh.reshape(c_shard, w)
        counts = counts_sh.reshape(c_shard)
        my_d = jax.lax.axis_index(axis).astype(jnp.int32)
        my_gid = my_d * k_cap + jnp.arange(k_cap, dtype=jnp.int32)

        edge_words, covs, valid = local_edges(words, counts)
        prev, ovf_join, ovf_pair = link(edge_words, valid, my_gid)
        prev = jnp.where(valid, prev, -1)

        def exact_rank(_):
            """Plain doubling + adaptive cycle break (break at min
            GLOBAL id — the normative sharded-cycle semantics)."""
            anc, dist, _, o1 = double(prev, valid, "dist")
            has_cycle = jax.lax.pmax(
                jnp.any(
                    valid & (dist >= (1 << min(steps, 29)))
                ).astype(jnp.int32),
                axis,
            ) > 0

            def with_break(_):
                _, mn, _, o_min = double(prev, valid, "min")
                # in_cycle: my ancestor still has a predecessor
                pstate = jnp.stack([prev, prev], axis=1)
                pans, o_q = query_round(pstate, anc, valid)
                in_cycle = valid & (pans[:, 0] >= 0)
                prev2 = jnp.where(in_cycle & (my_gid == mn), -1, prev)
                anc2, dist2, _, o_d = double(prev2, valid, "dist")
                return prev2, anc2, dist2, o_min | o_q | o_d

            def no_break(_):
                return prev, anc, dist, jnp.asarray(False)

            prev2, anc, dist, o_cycle = jax.lax.cond(
                has_cycle, with_break, no_break, None
            )
            return prev2, anc, dist, o1 | o_cycle

        if use_sampled:
            head, rank, s_ok, o_s = rank_sampled(prev, valid, my_gid)
            prev, anc, dist, o1 = jax.lax.cond(
                s_ok,
                lambda _: (prev, head, rank, o_s),
                exact_rank,
                None,
            )
        else:
            prev, anc, dist, o1 = exact_rank(None)

        # global unitig numbering
        heads = valid & (prev == -1)
        n_heads = jnp.sum(heads.astype(jnp.int32))
        # flatten: all_gather over a tuple axis stacks one dim per axis
        all_counts = jax.lax.all_gather(n_heads, axis).reshape(-1)  # [d]
        my_off = jnp.sum(
            jnp.where(jnp.arange(d) < my_d, all_counts, 0)
        )
        head_rank = jnp.cumsum(heads.astype(jnp.int32)) - 1 + my_off
        uid_state = jnp.stack(
            [jnp.where(heads, head_rank, -1)] * 2, axis=1
        )
        uans, o2 = query_round(uid_state, anc, valid)
        uid = jnp.where(valid, uans[:, 0], -1)

        num_unitigs = jnp.sum(all_counts)
        # bitmask, not bool: a flagged overflow at scale must say WHICH
        # routing cap to grow (bit 1 = link join, 2 = link pair,
        # 4 = rank/doubling query, 8 = uid query); nonzero == overflow
        overflow = jax.lax.pmax(
            ovf_join.astype(jnp.int32)
            + 2 * ovf_pair.astype(jnp.int32)
            + 4 * o1.astype(jnp.int32)
            + 8 * o2.astype(jnp.int32),
            axis,
        )
        last_base = (edge_words[:, -1] & jnp.uint32(3)).astype(jnp.uint8)
        return (
            valid, uid, dist, covs, last_base, heads,
            edge_words, num_unitigs[None], overflow,
        )

    spec_row = P(axis)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(
            spec_row, spec_row, spec_row, spec_row, spec_row, spec_row,
            P(axis, None), P(axis), P(),
        ),
        check_vma=False,
    )
    return jax.jit(mapped)


def peak_rows_per_device(d: int, c_shard: int) -> int:
    """Largest per-device buffer rows in the sharded compression.

    All buffers are static shapes proportional to c_shard = C_global/D, so
    per-device memory scales ~1/D; tests pin this arithmetic. (The spell
    reduction's buffers are smaller: its routing send buffer is
    d * cap_route ≈ 2 * k_cap rows of ONE int32 column, and its per-unitig
    buffers are O(num_unitigs) — genome-structure-sized, not edge-sized.)
    """
    k_cap = 2 * c_shard
    return max(2 * k_cap, d * _join_cap(k_cap, d))


@functools.lru_cache(maxsize=64)
def make_sharded_spell(
    mesh: Mesh, k: int, c_shard: int, u_block: int, axis=None,
    route_slack: float = 2.0,
):
    """Build the jitted sharded spelling reduction (range-sort spelling).

    The gathered-quads spelling (spell_quads_arrays) pulls every edge's
    (uid, pos, cov, words) to the host — O(E · ~22 B) across the slow
    device->host link, plus a host lexsort. Here the device mesh computes
    every edge's GLOBAL position in the (uid, pos)-sorted body stream
    directly — g = unitig_offset[uid] + pos, a bijection onto
    [0, E_valid) — and routes (g, base) to g's chunk owner, so no
    distributed sort is ever needed and per-chunk receive volume is
    exactly balanced by construction. The host then pulls only:

      * the 2-bit-packed base stream chunks (E/4 bytes total),
      * per-unitig lengths / coverage sums / head words (O(U) rows).

    Stages, one shard_map dispatch:
      1. per-unitig stats: local (count, cov-sum) partials per distinct
         uid (sort + neighbor-diff segment reduce), all-to-all'd to the
         uid's numbering device (uid ranges are contiguous per device by
         construction of the head numbering), owner-reduced, scattered
         into [u_block] shard tables;
      2. head tables: a head edge's uid was numbered on its own device,
         so head words scatter locally — zero communication;
      3. offsets: shard lengths all-gather (O(U) rows) -> masked global
         exclusive cumsum -> per-edge offset lookup;
      4. base routing: (g % k_cap)*4 | base packed in one int32 lane,
         bucket-packed to device g // k_cap, scattered by slot, packed
         4 bases/byte.

    Overflow (u_block or routing caps) is flagged, never silent; the caps
    are terminal at u_block = cap_route = k_cap (a sender cannot route
    more rows than it has), so the caller's retry loop provably lands.
    """
    axis = axis if axis is not None else mesh_axes(mesh)
    d = axis_size(mesh, axis)
    w = key_words(k)
    k_cap = 2 * c_shard
    k4 = -(-k_cap // 4) * 4
    cap_route = min(k_cap, int(k_cap / d * route_slack) + 128)
    big = jnp.uint32(BIG)

    def _segment_stats(uid_col, cnt_col, cov_col, n):
        """Per-distinct-uid (uid, sum cnt, sum cov) via sort + neighbor
        diff of exclusive cumsums; rows compacted to the front in uid
        order. Padding rows carry uid BIG."""
        s = jax.lax.sort((uid_col, cnt_col, cov_col), num_keys=1)
        u_s, c_s, v_s = s
        lane = jnp.arange(n, dtype=jnp.int32)
        start = jnp.concatenate([jnp.ones(1, bool), u_s[1:] != u_s[:-1]])
        ecnt = jnp.cumsum(c_s) - c_s
        ecov = jnp.cumsum(v_s) - v_s
        srt = jax.lax.sort(
            ((~start).astype(jnp.uint32), u_s, ecnt, ecov), num_keys=2
        )
        u_c, ecnt_c, ecov_c = srt[1], srt[2], srt[3]
        is_real = (srt[0] == 0) & (u_c < big)
        nr = jnp.sum(is_real.astype(jnp.int32))
        tot_cnt = jnp.sum(jnp.where(u_s < big, c_s, 0))
        tot_cov = jnp.sum(jnp.where(u_s < big, v_s, 0))
        nxt_cnt = jnp.concatenate([ecnt_c[1:], jnp.zeros(1, ecnt_c.dtype)])
        nxt_cov = jnp.concatenate([ecov_c[1:], jnp.zeros(1, ecov_c.dtype)])
        nxt_cnt = jnp.where(lane == nr - 1, tot_cnt, nxt_cnt)
        nxt_cov = jnp.where(lane == nr - 1, tot_cov, nxt_cov)
        cnt = jnp.where(is_real, nxt_cnt - ecnt_c, 0)
        cov = jnp.where(is_real, nxt_cov - ecov_c, 0)
        return u_c, cnt, cov, is_real

    def step(valid, uid, pos, cov, heads, edge_words):
        valid = valid.reshape(k_cap)
        uid = uid.reshape(k_cap)
        pos = pos.reshape(k_cap)
        cov = cov.reshape(k_cap)
        heads = heads.reshape(k_cap)
        edge_words = edge_words.reshape(k_cap, w)
        my_d = jax.lax.axis_index(axis).astype(jnp.int32)

        n_heads = jnp.sum(heads.astype(jnp.int32))
        all_counts = jax.lax.all_gather(n_heads, axis).reshape(-1)
        my_offs = jnp.cumsum(all_counts) - all_counts
        my_off = my_offs[my_d]
        u_ovf = jnp.any(all_counts > u_block)

        # -- head tables: local scatter, zero comms (see docstring)
        hslot = jnp.where(heads, uid - my_off, u_block)
        head_words_buf = (
            jnp.zeros((u_block, w), jnp.uint32)
            .at[hslot]
            .set(jnp.where(heads[:, None], edge_words, 0), mode="drop")
        )

        # -- per-unitig stats, routed to the uid's numbering device
        uid_adj = jnp.where(valid, uid, BIG).astype(jnp.uint32)
        ones = jnp.where(valid, 1, 0).astype(jnp.int32)
        u_c, cnt_p, cov_p, real_p = _segment_stats(
            uid_adj, ones, jnp.where(valid, cov, 0), k_cap
        )
        owner_u = jnp.clip(
            jnp.searchsorted(
                my_offs, u_c.astype(jnp.int32), side="right"
            ) - 1,
            0, d - 1,
        ).astype(jnp.int32)
        rec = jnp.stack([u_c.astype(jnp.int32), cnt_p, cov_p], axis=1)
        send, o1 = _bucket_pack(rec, owner_u, real_p, d, u_block)
        recv = jax.lax.all_to_all(
            send, axis, split_axis=0, concat_axis=0, tiled=False
        ).reshape(d * u_block, 3)
        ruid = jnp.where(recv[:, 0] >= 0, recv[:, 0], BIG).astype(jnp.uint32)
        u2c, len_u, cov_u, real2 = _segment_stats(
            ruid, recv[:, 1], recv[:, 2], d * u_block
        )
        slot2 = jnp.where(real2, u2c.astype(jnp.int32) - my_off, u_block)
        lengths_shard = (
            jnp.zeros(u_block, jnp.int32).at[slot2].set(len_u, mode="drop")
        )
        cov_shard = (
            jnp.zeros(u_block, jnp.int32).at[slot2].set(cov_u, mode="drop")
        )

        # -- global unitig offsets (masked cumsum over gathered lengths)
        lengths_all = jax.lax.all_gather(lengths_shard, axis).reshape(
            d, u_block
        )
        lu = jnp.arange(u_block, dtype=jnp.int32)
        vm = lu[None, :] < all_counts[:, None]
        flat_len = jnp.where(vm, lengths_all, 0).reshape(-1)
        excl_off = jnp.cumsum(flat_len) - flat_len
        o_dev = jnp.clip(
            jnp.searchsorted(my_offs, uid, side="right") - 1, 0, d - 1
        )
        fidx = jnp.clip(
            o_dev * u_block + uid - my_offs[o_dev], 0, d * u_block - 1
        )
        g = excl_off[fidx] + pos

        # -- base routing to the global position's chunk owner
        base2 = (edge_words[:, -1] & jnp.uint32(3)).astype(jnp.int32)
        pay = jnp.where(valid, (g % k_cap) * 4 + base2, -1)
        dest = jnp.where(valid, g // k_cap, 0).astype(jnp.int32)
        send2, o2 = _bucket_pack(pay[:, None], dest, valid, d, cap_route)
        recv2 = jax.lax.all_to_all(
            send2, axis, split_axis=0, concat_axis=0, tiled=False
        ).reshape(d * cap_route)
        bslot = jnp.where(recv2 >= 0, recv2 // 4, k4)
        bases_buf = (
            jnp.zeros(k4, jnp.uint8)
            .at[bslot]
            .set((recv2 & 3).astype(jnp.uint8), mode="drop")
        )
        quads = bases_buf.reshape(-1, 4)
        packed = (
            quads[:, 0]
            | (quads[:, 1] << 2)
            | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)
        )
        ovf = jax.lax.pmax((u_ovf | o1 | o2).astype(jnp.int32), axis) > 0
        return (
            packed, lengths_shard, cov_shard, head_words_buf,
            n_heads[None], ovf,
        )

    spec_row = P(axis)
    mapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            spec_row, spec_row, spec_row, spec_row, spec_row,
            P(axis, None),
        ),
        out_specs=(
            spec_row, spec_row, spec_row, P(axis, None), spec_row, P(),
        ),
        check_vma=False,
    )
    return jax.jit(mapped)


def spell_sharded_arrays(
    mesh, k, c_shard, num_unitigs,
    valid, uid, pos, cov, heads, edge_words,
    axis=None, u_block: int | None = None,
):
    """Range-sort sharded spelling -> UnitigArrays (see make_sharded_spell).

    Host transfer: E/4 bytes of packed bases + O(num_unitigs) per-unitig
    rows — vs spell_quads_arrays' O(E · ~22 B) per-edge quad gather.
    Retries with grown caps on a flagged overflow (terminal caps provably
    suffice, so the loop always lands).
    """
    from ..host.simplify_arrays import build_unitig_arrays
    from ..ops.count_jax import snug_capacity
    from ..utils.dna import unpack_codes_np
    from ..utils.jaxenv import to_host

    axis = axis if axis is not None else mesh_axes(mesh)
    d = axis_size(mesh, axis)
    k_cap = 2 * c_shard
    u = int(num_unitigs)
    w = key_words(k)
    if u == 0:
        return build_unitig_arrays(
            np.empty(0, np.uint8), np.empty(0, np.int64),
            np.empty(0, np.int64), np.empty((0, w), np.uint32), k,
        )
    u_block = u_block or min(
        k_cap, snug_capacity(-(-2 * u // d), floor=1 << 10)
    )
    route_slack = 2.0
    while True:
        spell = make_sharded_spell(
            mesh, k, c_shard, u_block, axis, route_slack
        )
        packed, lengths, covs, head_words, n_heads, ovf = spell(
            valid, uid, pos, cov, heads, edge_words
        )
        if not bool(to_host(ovf)):
            break
        if u_block >= k_cap and route_slack >= d:
            raise RuntimeError(
                "sharded spell overflow at terminal caps (unreachable by "
                "construction; see make_sharded_spell)"
            )
        u_block = min(k_cap, u_block * 4)
        route_slack = min(route_slack * 2, d)

    counts = np.asarray(to_host(n_heads))
    if int(counts.sum()) != u:
        raise AssertionError(
            f"spell head counts {int(counts.sum())} != num_unitigs {u}"
        )
    lengths_h = np.asarray(to_host(lengths)).reshape(d, u_block)
    covs_h = np.asarray(to_host(covs)).reshape(d, u_block)
    hw_h = np.asarray(to_host(head_words)).reshape(d, u_block, w)
    packed_h = np.asarray(to_host(packed)).reshape(d, -1)
    lens = np.concatenate(
        [lengths_h[j, : counts[j]] for j in range(d)]
    ).astype(np.int64)
    cov_sum = np.concatenate(
        [covs_h[j, : counts[j]] for j in range(d)]
    ).astype(np.int64)
    head_w = np.concatenate([hw_h[j, : counts[j]] for j in range(d)])
    total_body = int(lens.sum())
    # chunk j holds global body positions [j*k_cap, j*k_cap + k_cap)
    bases = np.concatenate(
        [
            unpack_codes_np(
                packed_h[j],
                min(k_cap, max(0, total_body - j * k_cap)),
            )
            for j in range(d)
        ]
    )
    return build_unitig_arrays(bases, lens, cov_sum, head_w, k)


def spell_quads_arrays(
    valid, uid, pos, cov, last_base, heads, edge_words, num_unitigs, k
):
    """Assemble columnar UnitigArrays from gathered per-edge quads.

    Host-RAM NumPy; mirrors host.dbg.spell_device_arrays' output exactly
    (same ordering and coverage semantics) so the downstream simplify/
    traverse stages are shared. No strings are built — array-native
    simplification consumes the packed codes directly.
    """
    from ..host.simplify_arrays import build_unitig_arrays
    from ..utils.jaxenv import to_host

    valid = to_host(valid)
    uid = to_host(uid)[valid]
    pos = to_host(pos)[valid]
    cov = to_host(cov)[valid]
    base = to_host(last_base)[valid]
    heads = to_host(heads)[valid]
    words = to_host(edge_words)[valid]
    u = int(num_unitigs)
    w = words.shape[1]
    if u == 0:  # e.g. a coverage filter that dropped every k-mer
        return build_unitig_arrays(
            np.empty(0, np.uint8), np.empty(0, np.int64),
            np.empty(0, np.int64), np.empty((0, w), np.uint32), k,
        )

    order = np.lexsort((pos, uid))
    uid_o = uid[order]
    base_o = base[order]
    lengths = np.bincount(uid_o, minlength=u).astype(np.int64)
    # exact int64 per-unitig coverage sums via cumsum-diff over the
    # uid-sorted order (bincount's float64 weight accumulation would
    # round above 2^53, breaking integer-coverage parity)
    bnd = np.cumsum(lengths)
    cov_cs = np.concatenate([[0], np.cumsum(cov[order].astype(np.int64))])
    cov_sum = cov_cs[bnd] - cov_cs[bnd - lengths]
    head_words = np.zeros((u, w), dtype=np.uint32)
    head_words[uid[heads]] = words[heads]
    return build_unitig_arrays(base_o, lengths, cov_sum, head_words, k)


def spell_quads_host(
    valid, uid, pos, cov, last_base, heads, edge_words, num_unitigs, k
):
    """String-form spelling (debug/comparison surface): decode the
    columnar spell into host Unitig objects."""
    from ..host.simplify_arrays import to_unitig_list

    return to_unitig_list(
        spell_quads_arrays(
            valid, uid, pos, cov, last_base, heads, edge_words, num_unitigs, k
        )
    )
