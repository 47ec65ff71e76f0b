"""XTree ALIGN device path: the hot per-position k-mer probe (xtree.c:1024-1081)
as a device step over a seeded-displacement hash.

The host engine's `_lookup` replays LBS_k (xtree.c:170-178) with a masked
bisection; on a device that is a chain of dependent gathers.  Instead the
device probes a canonical dual-value displaced hash (hash_index.place_displaced
— the same geometry as the utree tier-S table):

  key   = min(word, rc(word)) of the k-mer word (2k <= 62 bits in two lanes)
  entry = (key_lo, key_hi, seed_fwd+1, seed_rc+1), where the values are what
          the reference's own probe would return for each orientation —
          including the one-past-the-bin LBS_k quirk (xtree.c:177) — so ONE
          32B row gather answers both strands of a position exactly.

Everything downstream (run expansion, tallies, conf/aufbau, redistribution,
writers) stays in the exact host engine; the device only replaces the
encode+lookup front end, returning per-window (seed, prefix) for both
orientations in the reference's scan order."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from utree_tpu.hash_index import _mix_np, _rc64, place_displaced
from utree_tpu.xtree.build import XtreeDB


def _xtree_reference_hits(bins: np.ndarray, sfx: np.ndarray):
    """Every (prefix_bin, suffix) -> LBS_k result the aligner's `_lookup` can
    produce: per nonempty bin its distinct suffixes' first-occurrence indices,
    plus the one-past entry (p, sfx[end]) -> end when that suffix exceeds the
    bin's last (the C reads one pod past the bin, xtree.c:177)."""
    n = len(sfx) - 1  # sfx carries the sentinel pod
    starts = bins[:-1]
    ends = bins[1:]
    pop = np.flatnonzero(ends > starts)
    if len(pop) == 0:
        return (np.zeros(0, np.int64),) * 3
    # first occurrence of each distinct suffix within its bin
    bin_of = np.searchsorted(bins, np.arange(n), side="right") - 1
    first = np.ones(n, bool)
    if n > 1:
        first[1:] = (sfx[1:n] != sfx[: n - 1]) | (bin_of[1:] != bin_of[:-1])
    idx = np.flatnonzero(first)
    pre = bin_of[idx]
    suf = sfx[idx]
    val = idx
    # one-past entries
    b = ends[pop]
    last = sfx[b - 1]
    past = sfx[np.minimum(b, n)]
    take = past > last
    pre = np.concatenate([pre, pop[take]])
    suf = np.concatenate([suf, past[take]])
    val = np.concatenate([val, b[take]])
    return pre.astype(np.int64), suf.astype(np.int64), val.astype(np.int64)


def _rc_word_np(w: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2k-bit words held in uint64."""
    return _rc64(w.astype(np.uint64)) >> np.uint64(64 - 2 * k)


@dataclasses.dataclass
class XtreeDeviceIndex:
    tables: dict  # device-resident {d1, ds, d3}
    k: int
    pl: int
    sl: int
    num_entries: int


def build_xtree_device_index(db: XtreeDB, aligner_sfx: np.ndarray,
                             aligner_bins: np.ndarray) -> XtreeDeviceIndex:
    """Canonical displaced hash over the aligner's pod arrays (sentinel
    included, so the one-past quirk values match the host replay), capped
    at the memory budget of the default device it is placed onto."""
    import jax

    from utree_tpu.memory import table_budget

    k, pl, sl = db.k, db.pl, db.sl
    if 2 * k > 62:
        raise ValueError("xtree device path supports k <= 31")
    pre, suf, val = _xtree_reference_hits(aligner_bins, aligner_sfx)
    if len(val) and int(val.max()) >= 0x7FFFFFFE:
        raise ValueError("pod indices exceed int32 device lanes")
    w = (pre.astype(np.uint64) << np.uint64(2 * sl)) | suf.astype(np.uint64)
    r = _rc_word_np(w, k)
    c = np.minimum(w, r)
    is_fwd = w == c
    order = np.argsort(c, kind="stable")
    cs, isf, vals_s = c[order], is_fwd[order], val[order].astype(np.uint32)
    new = np.ones(len(cs), bool)
    if len(cs) > 1:
        new[1:] = cs[1:] != cs[:-1]
    gid = np.cumsum(new) - 1
    ng = int(gid[-1]) + 1 if len(cs) else 0
    va = np.zeros(ng, np.uint32)
    vb = np.zeros(ng, np.uint32)
    va[gid[isf]] = vals_s[isf] + np.uint32(1)
    vb[gid[~isf]] = vals_s[~isf] + np.uint32(1)
    ck = cs[new]
    pal = ck == _rc_word_np(ck, k)  # even k only; hits both scans
    vb[pal] = va[pal]
    vals2d = np.stack([va.view(np.int32), vb.view(np.int32)], axis=1)
    key_lo = (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    key_hi = (ck >> np.uint64(32)).astype(np.uint32).view(np.int32)
    chi32 = (ck >> np.uint64(32)).astype(np.int64)
    cpre = chi32 >> 8
    chi = chi32 & 0xFF
    clo = (ck & np.uint64(0xFFFFFFFF)).astype(np.int64)
    built = place_displaced(key_lo, key_hi, vals2d, cpre, chi, clo, ng,
                            t1_cap=table_budget(jax.devices()[0]))
    return XtreeDeviceIndex(tables=built.device_put(), k=k, pl=pl, sl=sl,
                            num_entries=ng)


# --------------------------------------------------------------------------
# Device step
# --------------------------------------------------------------------------

def _extract_windows_k(codes, k: int):
    """(B, T) codes -> k-mer lanes (w_hi, w_lo, valid), MSB-first; the first
    k-16 bases fill hi, the last 16 fill lo (14 <= k <= 31)."""
    import jax
    import jax.numpy as jnp

    b, t = codes.shape
    w = t - k + 1
    if w <= 0:
        raise ValueError("queries shorter than k after padding")
    w_hi = jnp.zeros((b, w), jnp.uint32)
    w_lo = jnp.zeros((b, w), jnp.uint32)
    valid = jnp.ones((b, w), jnp.bool_)
    nh = k - 16
    for j in range(k):
        c = jax.lax.dynamic_slice_in_dim(codes, j, w, axis=1)
        valid &= c <= 3
        cc = jnp.where(c <= 3, c, 0).astype(jnp.uint32)
        if j < nh:
            w_hi = w_hi | (cc << jnp.uint32(2 * (nh - 1 - j)))
        else:
            w_lo = w_lo | (cc << jnp.uint32(2 * (k - 1 - j)))
    return w_hi, w_lo, valid


def _rc_lanes_k(w_hi, w_lo, k: int):
    """RC of 2k-bit words in (hi, lo) u32 lanes (rev2 + complement + shift)."""
    import jax.numpy as jnp

    from utree_tpu.lookup import _rev2_32

    r_lo_t = _rev2_32(~w_hi)
    r_hi_t = _rev2_32(~w_lo)
    s = 64 - 2 * k
    if s == 0:
        return r_hi_t, r_lo_t
    if s < 32:
        rc_lo = (r_lo_t >> jnp.uint32(s)) | (r_hi_t << jnp.uint32(32 - s))
        rc_hi = r_hi_t >> jnp.uint32(s)
    elif s == 32:
        rc_lo, rc_hi = r_hi_t, jnp.zeros_like(r_hi_t)
    else:
        rc_lo = r_hi_t >> jnp.uint32(s - 32)
        rc_hi = jnp.zeros_like(r_hi_t)
    return rc_hi, rc_lo


def _prefix_of(w_hi, w_lo, sl: int):
    import jax.numpy as jnp

    b = 2 * sl
    if b < 32:
        return ((w_hi << jnp.uint32(32 - b)) | (w_lo >> jnp.uint32(b))).astype(jnp.int32)
    if b == 32:
        return w_hi.astype(jnp.int32)
    return (w_hi >> jnp.uint32(b - 32)).astype(jnp.int32)


def xtree_device_step(tables: dict, reads_u8, lengths, *, k: int, sl: int):
    """(B, T) ASCII queries -> per-window (seed_f, seed_r, pre_f, pre_r)
    int32 matrices (seed = LBS_k pod index, -1 = miss), scan-order exact."""
    import jax
    import jax.numpy as jnp

    from utree_tpu.lookup import base_codes, displaced_probe_raw

    codes = base_codes(reads_u8, lengths)
    w_hi, w_lo, valid = _extract_windows_k(codes, k)
    r_hi, r_lo = _rc_lanes_k(w_hi, w_lo, k)
    fwd_le = (w_hi < r_hi) | ((w_hi == r_hi) & (w_lo <= r_lo))
    c_hi = jnp.where(fwd_le, w_hi, r_hi)
    c_lo = jnp.where(fwd_le, w_lo, r_lo)
    key_lo = jax.lax.bitcast_convert_type(c_lo, jnp.int32)
    key_hi = jax.lax.bitcast_convert_type(c_hi, jnp.int32)
    va, vb = displaced_probe_raw(tables, key_lo, key_hi, valid, wide=True)
    seed_c = va - 1   # value for the canonical word's orientation
    seed_rc = vb - 1  # value for its reverse complement
    seed_f = jnp.where(valid, jnp.where(fwd_le, seed_c, seed_rc), -1)
    seed_r = jnp.where(valid, jnp.where(fwd_le, seed_rc, seed_c), -1)
    pre_f = _prefix_of(w_hi, w_lo, sl)
    pre_r = _prefix_of(r_hi, r_lo, sl)
    return seed_f, seed_r, pre_f, pre_r


def make_device_step(index: XtreeDeviceIndex):
    import jax

    return jax.jit(functools.partial(xtree_device_step, k=index.k, sl=index.sl))
