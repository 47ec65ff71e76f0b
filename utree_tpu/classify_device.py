"""Aufbau vote on device (SURVEY §7 step 6).

The GG vote (itree.c:1028-1098) is a character-level walk over the read's
unique hit labels sorted by taxonomy string.  Its character probes depend
only on the LABEL STRINGS, so everything stringy is precomputed per label at
load time (the same move xtree's LBins makes for its LCA, xtree.c:810-875):

  - string-sort ranks (the walk compares only subset-ADJACENT entries);
  - pairwise LCP via a range-min sparse table over adjacent-rank LCPs
    (lcp(a, b) = min of adjacent lcps between their ranks);
  - per-label ';' / '_' position bitmasks + sorted ';' positions;
  - string lengths.

With those, every branch of the walk is integer arithmetic, and the whole
vote runs as a `lax.while_loop` over (B,) lanes on device — the device then
returns ~12B/read (winner label, divergence index, support pair) instead of
per-read histograms, and the host only formats output lines.

Counters are uint32 with wraparound, exactly like the reference's (the
Python twin `classify._aufbau_walk` replays the same wrap semantics and is
the exactness oracle for these kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# dv sentinel codes returned in the packed result
DV_INTERP = 0   # toprint = rep string cut at dv chars
DV_EMPTY = 1    # dv == (uint32)-1: toprint = ""
DV_FULL = 2     # dv == (uint32)-2: toprint = full rep string

_U32_M1 = np.uint32(0xFFFFFFFF)
_U32_M2 = np.uint32(0xFFFFFFFE)


@dataclasses.dataclass
class AufbauTables:
    """Per-label integer metadata for the device walk (host numpy)."""

    rank_of_label: np.ndarray  # (L,) int32: position in string-sorted order
    st_tab: np.ndarray  # (nlev, L) int32 range-min sparse table over adj lcps
    slen: np.ndarray  # (L,) int32
    semi_mask: np.ndarray  # (L, W) uint32, bit p%32 of word p//32 = ';' at p
    und_mask: np.ndarray  # (L, W) uint32, same for '_'
    semi_pos: np.ndarray  # (L, R) int32 sorted ';' positions, pad = BIG
    max_len: int

    BIG = np.int32(0x3FFFFFFF)

    def device_put(self, sharding=None):
        import jax

        return {
            "rank": jax.device_put(self.rank_of_label, sharding),
            "st": jax.device_put(self.st_tab, sharding),
            "slen": jax.device_put(self.slen, sharding),
            "semi": jax.device_put(self.semi_mask, sharding),
            "und": jax.device_put(self.und_mask, sharding),
            "spos": jax.device_put(self.semi_pos, sharding),
        }


def build_aufbau_tables(strings: list[bytes]) -> AufbauTables:
    L = len(strings)
    order = sorted(range(L), key=lambda i: strings[i])
    rank_of_label = np.zeros(L, np.int32)
    for r, i in enumerate(order):
        rank_of_label[i] = r
    max_len = max((len(s) for s in strings), default=0)
    # adjacent-rank LCPs
    adj = np.zeros(max(L, 1), np.int32)
    for r in range(1, L):
        a, b = strings[order[r - 1]], strings[order[r]]
        m = min(len(a), len(b))
        p = 0
        while p < m and a[p] == b[p]:
            p += 1
        adj[r] = p
    nlev = max(1, int(np.ceil(np.log2(max(L, 2)))) + 1)
    st_tab = np.zeros((nlev, max(L, 1)), np.int32)
    st_tab[0] = adj
    for j in range(1, nlev):
        h = 1 << (j - 1)
        shifted = np.minimum(np.arange(max(L, 1)) + h, max(L, 1) - 1)
        st_tab[j] = np.minimum(st_tab[j - 1], st_tab[j - 1][shifted])
    slen = np.array([len(s) for s in strings], np.int32).reshape(L)
    W = max(1, (max_len + 31) // 32)
    semi_mask = np.zeros((L, W), np.uint32)
    und_mask = np.zeros((L, W), np.uint32)
    max_semis = 1
    for i, s in enumerate(strings):
        for p, ch in enumerate(s):
            if ch == 0x3B:
                semi_mask[i, p // 32] |= np.uint32(1) << np.uint32(p % 32)
            elif ch == 0x5F:
                und_mask[i, p // 32] |= np.uint32(1) << np.uint32(p % 32)
        max_semis = max(max_semis, s.count(b";"))
    R = max_semis + 1
    semi_pos = np.full((L, R), int(AufbauTables.BIG), np.int32)
    for i, s in enumerate(strings):
        k = 0
        for p, ch in enumerate(s):
            if ch == 0x3B:
                semi_pos[i, k] = p
                k += 1
    return AufbauTables(rank_of_label, st_tab, slen, semi_mask, und_mask,
                        semi_pos, max_len)


def aufbau_walk_device(tab: dict, labels, counts, nuniq, found, *,
                       taxacut: int, max_iters: int):
    """Vectorized `classify._aufbau_walk` (itree.c:1044-1096) over a batch.

    labels/counts: (B, C) compact histograms, labels ascending by id (-1
    pads); nuniq (B,) TRUE unique counts (> C = overflow); found (B,) total
    hits.  Returns int32 (rep_label, dvcode, dv, sl, ol, flag) per read —
    flag=1 marks reads the device could not finish (nuniq > C, or the
    iteration cap; the host replays those exactly).  Reads with nuniq <= 1
    are short-circuited (their line needs no walk).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    B, C = labels.shape
    u32 = jnp.uint32
    i32 = jnp.int32
    BIG = jnp.int32(int(AufbauTables.BIG))

    # sort each read's entries by string rank (tax_cnt qsort, itree.c:1041)
    rank = jnp.where(labels >= 0, tab["rank"][jnp.maximum(labels, 0)], BIG)
    order = jnp.argsort(rank, axis=1)
    ent_lab = jnp.take_along_axis(labels, order, axis=1)
    ent_cnt = jnp.take_along_axis(counts, order, axis=1).astype(u32)
    ent_rank = jnp.take_along_axis(rank, order, axis=1)

    def ent(mat, idx):
        return jnp.take_along_axis(
            mat, jnp.clip(idx, 0, C - 1)[:, None], axis=1)[:, 0]

    slen = tab["slen"]
    spos = tab["spos"]
    stt = tab["st"]
    semi = tab["semi"]
    und = tab["und"]

    def char0(lab, p):
        # C-string NUL at p (p is uint32; positions past len read 0)
        return p >= slen[lab].astype(u32)

    def bit_at(mask, lab, p):
        pi = p.astype(i32)
        w = mask[lab, jnp.clip(pi >> 5, 0, mask.shape[1] - 1)]
        return (~char0(lab, p)) & (((w >> (pi & 31).astype(jnp.uint32))
                                    & jnp.uint32(1)) == 1)

    def next_semi(lab, p):
        ps = spos[lab]  # (B, R)
        cand = jnp.where(ps >= p.astype(i32)[:, None], ps, BIG)
        return jnp.min(cand, axis=1).astype(u32)

    def lcp(ra, rb):
        # range-min over adjacent lcps in (ra, rb]; requires ra < rb
        n = (rb - ra).astype(i32)
        m = 31 - lax.clz(jnp.maximum(n, 1))
        lo = stt[jnp.clip(m, 0, stt.shape[0] - 1), ra + 1]
        hi = stt[jnp.clip(m, 0, stt.shape[0] - 1),
                 jnp.maximum(rb - (1 << m) + 1, 0)]
        return jnp.minimum(lo, hi).astype(u32)

    def cut(x):
        c = x - x // u32(taxacut)
        return c + jnp.where((x >> 1) >= c, u32(1), u32(0))

    found_u = found.astype(u32)
    uix = jnp.minimum(nuniq, C).astype(i32)
    walk = (nuniq >= 2) & (nuniq <= C) & (found >= 2)
    over = nuniq > C

    st0 = jnp.zeros(B, i32)
    ed0 = uix
    dv0 = jnp.full(B, _U32_M1, u32)
    orun0 = found_u
    cut0 = cut(found_u)
    run0 = ent_cnt[:, 0]
    td0 = dv0
    z0 = jnp.ones(B, i32)
    sl0 = jnp.zeros(B, u32)
    ol0 = jnp.zeros(B, u32)
    done0 = ~walk
    it0 = jnp.int32(0)

    def cond(s):
        return (~s[0]).any() & (s[-1] < max_iters)

    def body(s):
        done, st, ed, z, dv, td, run, orun, cutoff, sl, ol, it = s
        act = ~done
        in_inner = act & (z < ed)
        # ---- INNER step (itree.c:1048-1079) ----
        lab1 = ent(ent_lab, z - 1)
        cnt1 = ent(ent_cnt, z - 1)
        lab2 = ent(ent_lab, z)
        cnt2 = ent(ent_cnt, z)
        r1 = ent(ent_rank, z - 1)
        r2 = ent(ent_rank, z)
        probe = jnp.where(dv == _U32_M1, u32(0), dv)
        case0 = char0(lab1, probe)  # s1 exhausted at current depth: drop it
        l12 = lcp(r1, r2)
        stop = jnp.minimum(slen[lab1].astype(u32), l12)
        tdn = jnp.minimum(next_semi(lab1, dv + u32(1)), stop)
        c_eq = tdn < l12
        c1_0 = char0(lab1, tdn)
        c1_semi = bit_at(semi, lab1, tdn)
        c2_semi = bit_at(semi, lab2, tdn)
        c1_und = (tdn >= 1) & bit_at(und, lab1, tdn - u32(1))
        promo = (c1_0 & c2_semi) | ((c1_semi | c1_0) & c1_und)
        case1 = (~case0) & c_eq
        case2 = (~case0) & (~c_eq) & promo
        case3 = (~case0) & (~c_eq) & (~promo) & (run >= cutoff)
        case4 = (~case0) & (~c_eq) & (~promo) & (run < cutoff)
        drop = in_inner & (case0 | case2)
        n_run = jnp.where(case1, run + cnt2,
                          jnp.where(case0 | case2 | case4, cnt2, run))
        n_orun = jnp.where(drop, orun - cnt1, orun)
        n_cut = jnp.where(drop, cut(n_orun), cutoff)
        n_st = jnp.where(in_inner & (case0 | case2 | case4), z, st)
        n_td = jnp.where(in_inner & ~case0, tdn, td)
        n_ed = jnp.where(in_inner & case3, z, ed)
        n_z = jnp.where(in_inner & ~case3, z + 1, z)
        run = jnp.where(in_inner, n_run, run)
        orun = jnp.where(in_inner, n_orun, orun)
        cutoff = jnp.where(in_inner, n_cut, cutoff)
        st = jnp.where(in_inner, n_st, st)
        td = n_td
        ed = n_ed
        z = n_z
        # ---- AFTER the inner loop (itree.c:1080-1096) ----
        after = act & (z >= ed)
        sl = jnp.where(after, run, sl)
        ol = jnp.where(after, orun, ol)
        exit1 = after & (run < cutoff)
        single = after & (~exit1) & (st + 1 >= ed)
        last_cnt = ent(ent_cnt, ed - 1)
        dv = jnp.where(single & (last_cnt >= cutoff), _U32_M2, dv)
        descend = after & (~exit1) & (~single)
        # OUTER re-init (itree.c:1081-1086 tail + loop head)
        orun = jnp.where(descend, run, orun)
        dv = jnp.where(descend, td, dv)
        cutoff = jnp.where(descend, cut(run), cutoff)
        run = jnp.where(descend, ent(ent_cnt, st), run)
        td = jnp.where(descend, dv, td)
        z = jnp.where(descend, st + 1, z)
        done = done | exit1 | single
        return done, st, ed, z, dv, td, run, orun, cutoff, sl, ol, it + 1

    state = (done0, st0, ed0, z0, dv0, td0, run0, orun0, cut0, sl0, ol0, it0)
    done, st, ed, z, dv, td, run, orun, cutoff, sl, ol, it = lax.while_loop(
        cond, body, state)

    hit_cap = walk & ~done  # defensive: never expected, host replays
    rep = ent(ent_lab, ed - 1)
    dvcode = jnp.where(dv == _U32_M1, i32(DV_EMPTY),
                       jnp.where(dv == _U32_M2, i32(DV_FULL), i32(DV_INTERP)))
    # nuniq <= 1 short-circuits: rep = the single label, full string
    triv = nuniq <= 1
    rep = jnp.where(triv, labels[:, 0], rep)
    dvcode = jnp.where(triv, i32(DV_FULL), dvcode)
    flag = (over | hit_cap).astype(i32)
    return (rep.astype(i32), dvcode, dv.astype(i32), sl.astype(i32),
            ol.astype(i32), flag)
