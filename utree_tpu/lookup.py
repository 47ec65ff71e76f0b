"""Device-side window extraction and k-mer lookup (jit path).

Window extraction turns a padded batch of ASCII reads into per-window
(prefix24, suffix_hi8, suffix_lo32) lanes + validity mask — the vectorized
equivalent of the search scan loop (XT_WORD_SEARCH, itree.c:903-933) with the
RC text append (itree.c:891-897).

Lookup replays the reference probe sequence (xtSuffixBS + XT_getIX32,
itree.c:699-730) exactly: `while size: w=size>>1; if suf[p+w+1] <= q:
p+=w+1, size-=w+1 else size=w`, with the 40-bit suffix comparison done on
two 32-bit lanes (hi8:int32, lo32:uint32); every device word is held in
such lanes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# device-side base-code table: A=0 C=1 G=2 T=3, INVALID=4 (compact for device)
DINVALID = 4
_DEV_CODE = np.full(256, DINVALID, dtype=np.int32)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    for _ch in _b:
        _DEV_CODE[_ch] = _c


def base_codes(reads_u8: jax.Array, lengths: jax.Array) -> jax.Array:
    """(B, L) uint8 ASCII -> (B, L) int32 codes; positions >= length invalid."""
    table = jnp.asarray(_DEV_CODE)
    codes = table[reads_u8.astype(jnp.int32)]
    pos = jax.lax.broadcasted_iota(jnp.int32, codes.shape, 1)
    return jnp.where(pos < lengths[:, None], codes, DINVALID)


def base_codes_packed(packed: jax.Array, vbits: jax.Array, lengths: jax.Array) -> jax.Array:
    """2-bit-packed reads -> (B, L) int32 codes.

    packed (B, L/4) uint8: 4 bases/byte MSB-first; vbits (B, L/8) uint8:
    np.packbits validity (1 = ACGT).  Shrinks the host->device transfer ~2.7x
    vs ASCII; unpack is shift/mask only (no gathers)."""
    b, l4 = packed.shape
    l = l4 * 4
    rep = jnp.repeat(packed.astype(jnp.int32), 4, axis=1)
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
    codes = (rep >> (2 * (3 - (pos & 3)))) & 3
    vrep = jnp.repeat(vbits.astype(jnp.int32), 8, axis=1)[:, :l]
    ok = ((vrep >> (7 - (pos & 7))) & 1) == 1
    ok &= pos < lengths[:, None]
    return jnp.where(ok, codes, DINVALID)


def pack_reads_host(reads_u8: np.ndarray, lengths: np.ndarray):
    """Host-side 2-bit packing of an ASCII (B, L) batch (L % 8 == 0)."""
    codes = _DEV_CODE[reads_u8]
    valid = codes <= 3
    c = np.where(valid, codes, 0).astype(np.uint8)
    packed = (c[:, 0::4] << 6) | (c[:, 1::4] << 4) | (c[:, 2::4] << 2) | c[:, 3::4]
    vbits = np.packbits(valid, axis=1)
    return packed, vbits, lengths.astype(np.int32)


def append_rc(codes: jax.Array, lengths: jax.Array) -> jax.Array:
    """(B, L) codes -> (B, 2L+1): forward, sentinel, reverse complement.

    Mirrors the search's text-level RC append (itree.c:891-897): position
    `length` becomes a sentinel (invalid), positions length+1..2*length hold
    3-code of the read reversed (invalid stays invalid)."""
    b, l = codes.shape
    t = jax.lax.broadcasted_iota(jnp.int32, (b, 2 * l + 1), 1)
    ln = lengths[:, None]
    rc_idx = jnp.clip(2 * ln - t, 0, l - 1)
    rc_src = jnp.take_along_axis(codes, rc_idx, axis=1)
    rc_val = jnp.where(rc_src <= 3, 3 - rc_src, DINVALID)
    fwd_idx = jnp.clip(t, 0, l - 1)
    fwd_val = jnp.take_along_axis(codes, fwd_idx, axis=1)
    return jnp.where(t < ln, fwd_val, jnp.where((t > ln) & (t <= 2 * ln), rc_val, DINVALID))


def extract_windows(codes: jax.Array, k: int = 32):
    """Slide k-mers over (B, T) codes.

    Returns (qpre int32, qhi int32, qlo uint32, valid bool), each (B, T-k+1).
    Packing is MSB-first 2 bits/base (itree.c:617-621) split as the .ctr does:
    prefix = first 12 bases, suffix hi = bases 12..15, lo = bases 16..31.
    For k=64 call with the two-lane variant (see extract_windows64)."""
    if k != 32:
        raise NotImplementedError("extract_windows implements the 32-mer geometry")
    b, t = codes.shape
    w = t - k + 1
    if w <= 0:
        raise ValueError("reads shorter than k after padding")
    qpre = jnp.zeros((b, w), jnp.int32)
    qhi = jnp.zeros((b, w), jnp.int32)
    qlo = jnp.zeros((b, w), jnp.uint32)
    valid = jnp.ones((b, w), jnp.bool_)
    for j in range(k):
        c = jax.lax.dynamic_slice_in_dim(codes, j, w, axis=1)
        valid &= c <= 3
        cc = jnp.where(c <= 3, c, 0)
        if j < 12:
            qpre = qpre | (cc << (2 * (11 - j)))
        elif j < 16:
            qhi = qhi | (cc << (2 * (15 - j)))
        else:
            qlo = qlo | (cc.astype(jnp.uint32) << (2 * (31 - j)))
    return qpre, qhi, qlo, valid


def _rev2_32(x):
    """Reverse the 2-bit groups of a 32-bit lane (base order reversal)."""
    x = x.astype(jnp.uint32)
    x = ((x & jnp.uint32(0x33333333)) << jnp.uint32(2)) | ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) | ((x >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) | ((x >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF))
    x = (x << jnp.uint32(16)) | (x >> jnp.uint32(16))
    return x


def rc_word_lanes(qpre, qhi, qlo):
    """Reverse-complement 32-mer words directly on their (pre24, hi8, lo32)
    lanes — pure bit arithmetic, no gathers.

    The reference appends 'N' + revcomp(text) and rescans (itree.c:891-897);
    the RC text's valid-window word multiset is exactly {revcomp(w)} over the
    valid forward windows, and the vote is order-independent, so computing RC
    words arithmetically is result-identical and skips re-encoding."""
    lo_u = qlo.astype(jnp.uint32)
    # forward bases: pre24 = b0..b11, hi8 = b12..b15, lo32 = b16..b31
    rc_pre = (_rev2_32(~lo_u & jnp.uint32(0x00FFFFFF)) >> jnp.uint32(8)).astype(jnp.int32)
    rc_hi = (_rev2_32(~lo_u & jnp.uint32(0xFF000000)) & jnp.uint32(0xFF)).astype(jnp.int32)
    fwd_top = (qpre.astype(jnp.uint32) << jnp.uint32(8)) | qhi.astype(jnp.uint32)
    rc_lo = _rev2_32(~fwd_top)
    return rc_pre, rc_hi, rc_lo


def _suffix_le(hi_a, lo_a, hi_b, lo_b):
    """(hi_a, lo_a) <= (hi_b, lo_b) on 40-bit suffix lanes; the low lane is a
    32-bit payload and must always compare unsigned."""
    lo_a = lo_a.astype(jnp.uint32)
    lo_b = lo_b.astype(jnp.uint32)
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a <= lo_b))


@functools.partial(jax.jit, static_argnames=("probe_iters", "bad_ix"))
def lookup_kmers(
    table: dict,
    qpre: jax.Array,
    qhi: jax.Array,
    qlo: jax.Array,
    valid: jax.Array,
    probe_iters: int,
    bad_ix: int,
):
    """Batched exact replay of XT_getIX32 (itree.c:720-730).

    `table` = {bin_ix, suf_hi, suf_lo, ix} from DeviceIndexArrays.device_put.
    Returns int32 label ids, bad_ix for misses/invalid windows."""
    bin_ix, suf_hi, suf_lo, ix_arr = table["bin_ix"], table["suf_hi"], table["suf_lo"], table["ix"]
    n = suf_hi.shape[0] - 1  # one sentinel pad record

    pre = jnp.where(valid, qpre, 0)
    start = bin_ix[pre].astype(jnp.int32)
    end = bin_ix[pre + 1].astype(jnp.int32)
    empty = start >= end
    p = jnp.where(empty, 0, start)
    size = jnp.where(empty, 0, end - start - 1)

    def body(_, carry):
        p, size = carry
        active = size > 0
        w = size >> 1
        probe = jnp.minimum(p + w + 1, n)
        le = active & _suffix_le(suf_hi[probe], suf_lo[probe], qhi, qlo)
        p = jnp.where(le, p + w + 1, p)
        size = jnp.where(active, jnp.where(le, size - w - 1, w), size)
        return p, size

    p, _ = jax.lax.fori_loop(0, probe_iters, body, (p, size))
    p = jnp.minimum(p, n)
    found = (~empty) & valid & (suf_hi[p] == qhi) & (suf_lo[p] == qlo)
    return jnp.where(found, ix_arr[p], bad_ix)


def _mix_jnp(pre, hi, lo):
    """jnp twin of hash_index._mix_np — must produce identical uint32 values."""
    m1 = jnp.uint32(0x9E3779B1)
    m2 = jnp.uint32(0x85EBCA6B)
    m3 = jnp.uint32(0xC2B2AE35)
    lo_u = lo.astype(jnp.uint32)
    h = pre.astype(jnp.uint32) * m1
    h = h ^ (lo_u ^ (lo_u >> jnp.uint32(16)))
    h = h * m2
    h = h ^ (h >> jnp.uint32(13))
    h = h + hi.astype(jnp.uint32) * m3
    h = h ^ (h >> jnp.uint32(16))
    h = h * m1
    h = h ^ (h >> jnp.uint32(15))
    return h


def lookup_kmers_hash(hash_table: dict, qpre, qhi, qlo, valid, *, slots: int, bad_ix: int):
    """Exact hash lookup: two contiguous row gathers per k-mer (see
    hash_index.py).  Result-identical to lookup_kmers."""
    t1, t2 = hash_table["t1"], hash_table["t2"]
    b1, b2 = t1.shape[0], t2.shape[0]

    def bits_i32(x):
        return jax.lax.bitcast_convert_type(x.astype(jnp.uint32), jnp.int32)

    key_lo = bits_i32(qlo)
    key_hi = bits_i32(
        (qpre.astype(jnp.uint32) << jnp.uint32(8)) | qhi.astype(jnp.uint32)
    )

    def probe(table, bucket):
        rows = table[bucket]  # (..., slots*3) one contiguous row gather
        ix = jnp.zeros(bucket.shape, jnp.int32)
        found = jnp.zeros(bucket.shape, bool)
        for s in range(slots):
            m = (
                (rows[..., s * 3] == key_lo)
                & (rows[..., s * 3 + 1] == key_hi)
                & (rows[..., s * 3 + 2] >= 0)
            )
            ix = jnp.where(m, rows[..., s * 3 + 2], ix)
            found |= m
        return found, ix

    h1 = _mix_jnp(qpre, qhi, qlo)
    # invalid windows probe bucket 0 (served from on-chip cache, not HBM)
    f1, ix1 = probe(t1, jnp.where(valid, (h1 & jnp.uint32(b1 - 1)).astype(jnp.int32), 0))
    lo2 = qlo.astype(jnp.uint32) ^ jnp.uint32(0x5BD1E995)
    h2 = _mix_jnp(qpre, qhi, lo2)
    f2, ix2 = probe(t2, jnp.where(valid, (h2 & jnp.uint32(b2 - 1)).astype(jnp.int32), 0))
    out = jnp.where(f1, ix1, jnp.where(f2, ix2, bad_ix))
    return jnp.where(valid, out, bad_ix)


def canonical_keys(qpre, qhi, qlo):
    """Forward word lanes -> canonical-word key lanes + orientation.

    Returns (key_lo i32, key_hi i32, fwd_le bool) where (key_hi, key_lo) are
    the bit lanes of c = min(word, rc(word)) — the canonical dual-value hash's
    key (hash_index.CanonicalHashArrays)."""
    lo_u = qlo.astype(jnp.uint32)
    fwd_hi32 = (qpre.astype(jnp.uint32) << jnp.uint32(8)) | qhi.astype(jnp.uint32)
    rpre, rhi, rlo = rc_word_lanes(qpre, qhi, qlo)
    rc_hi32 = (rpre.astype(jnp.uint32) << jnp.uint32(8)) | rhi.astype(jnp.uint32)
    rlo_u = rlo.astype(jnp.uint32)
    fwd_le = (fwd_hi32 < rc_hi32) | ((fwd_hi32 == rc_hi32) & (lo_u <= rlo_u))
    c_hi32 = jnp.where(fwd_le, fwd_hi32, rc_hi32)
    c_lo = jnp.where(fwd_le, lo_u, rlo_u)
    key_lo = jax.lax.bitcast_convert_type(c_lo, jnp.int32)
    key_hi = jax.lax.bitcast_convert_type(c_hi32, jnp.int32)
    return key_lo, key_hi, fwd_le


def canonical_buckets(key_lo, key_hi, valid, b1: int, b2: int):
    """Bucket ids for both canonical tables; invalid windows probe bucket 0
    (served from on-chip cache instead of a random HBM touch).  Must mirror
    hash_index's builder mixes exactly."""
    c_lo = key_lo.astype(jnp.uint32)
    c_hi32 = key_hi.astype(jnp.uint32)
    c_pre = (c_hi32 >> jnp.uint32(8)).astype(jnp.int32)
    c_hi8 = (c_hi32 & jnp.uint32(0xFF)).astype(jnp.int32)
    # folded two-mix bucket hash: a single 32-bit mix leaves birthday-
    # colliding key pairs no table growth can split
    h1 = _mix_jnp(c_pre, c_hi8, c_lo)
    hb = _mix_jnp(c_pre, c_hi8, c_lo ^ jnp.uint32(0x6A09E667))
    g = h1 ^ ((hb << jnp.uint32(15)) | (hb >> jnp.uint32(17)))
    bkt1 = jnp.where(valid, (g & jnp.uint32(b1 - 1)).astype(jnp.int32), 0)
    h2 = _mix_jnp(c_pre, c_hi8, c_lo ^ jnp.uint32(0x5BD1E995))
    bkt2 = jnp.where(valid, (h2 & jnp.uint32(b2 - 1)).astype(jnp.int32), 0)
    return bkt1, bkt2


def canonical_bucket3(key_lo, key_hi, valid, b3: int):
    """t3 bucket ids (the 3-level tier's cached tail); mirrors the builder's
    0x27D4EB2F-salted mix."""
    c_lo = key_lo.astype(jnp.uint32)
    c_hi32 = key_hi.astype(jnp.uint32)
    c_pre = (c_hi32 >> jnp.uint32(8)).astype(jnp.int32)
    c_hi8 = (c_hi32 & jnp.uint32(0xFF)).astype(jnp.int32)
    h3 = _mix_jnp(c_pre, c_hi8, c_lo ^ jnp.uint32(0x27D4EB2F))
    return jnp.where(valid, (h3 & jnp.uint32(b3 - 1)).astype(jnp.int32), 0)


def probe_rows(rows, key_lo, key_hi, nslots: int):
    """Vectorized slot compare over gathered bucket rows (..., nslots*3):
    returns the matching entry's packed dual value, 0 = no entry."""
    val = jnp.zeros(key_lo.shape, jnp.int32)
    for s in range(nslots):
        m = (
            (rows[..., s * 3] == key_lo)
            & (rows[..., s * 3 + 1] == key_hi)
            & (rows[..., s * 3 + 2] != 0)
        )
        val = jnp.where(m, rows[..., s * 3 + 2], val)
    return val


def probe_rows_wide(rows, key_lo, key_hi, nslots: int):
    """Wide-entry (4-col slot) variant of probe_rows: returns (va, vb) int32
    raw values (label ix + 1; 0 = that orientation missing / empty slot)."""
    va = jnp.zeros(key_lo.shape, jnp.int32)
    vb = jnp.zeros(key_lo.shape, jnp.int32)
    for s in range(nslots):
        m = (
            (rows[..., s * 4] == key_lo)
            & (rows[..., s * 4 + 1] == key_hi)
            & ((rows[..., s * 4 + 2] | rows[..., s * 4 + 3]) != 0)
        )
        va = jnp.where(m, rows[..., s * 4 + 2], va)
        vb = jnp.where(m, rows[..., s * 4 + 3], vb)
    return va, vb


def decode_canonical_wide(va, vb, valid, fwd_le, bad_ix: int, do_rc: bool):
    """(va, vb) raw wide values -> per-window label ids (multiset contract
    identical to decode_canonical_vals; ids up to 2^31-2)."""
    ia = va - 1
    ib = vb - 1
    if do_rc:
        ix_a = jnp.where(valid & (ia >= 0), ia, bad_ix)
        ix_b = jnp.where(valid & (ib >= 0), ib, bad_ix)
        return ix_a, ix_b
    fwd = jnp.where(fwd_le, ia, ib)
    return jnp.where(valid & (fwd >= 0), fwd, bad_ix)


def decode_canonical_vals(val, valid, fwd_le, bad_ix: int, do_rc: bool):
    """Packed dual value -> per-window label ids (the exact reference hit
    multiset; see CanonicalHashArrays)."""
    vu = jax.lax.bitcast_convert_type(val, jnp.uint32)
    va = (vu & jnp.uint32(0xFFFF)).astype(jnp.int32) - 1  # ix of canonical word
    vb = (vu >> jnp.uint32(16)).astype(jnp.int32) - 1  # ix of its RC
    if do_rc:
        ix_a = jnp.where(valid & (va >= 0), va, bad_ix)
        ix_b = jnp.where(valid & (vb >= 0), vb, bad_ix)
        return ix_a, ix_b
    fwd = jnp.where(fwd_le, va, vb)
    return jnp.where(valid & (fwd >= 0), fwd, bad_ix)


def lookup_kmers_canonical(tables: dict, qpre, qhi, qlo, valid, *,
                           slots: int, slots2: int, bad_ix: int, do_rc: bool,
                           wide: bool = False):
    """Canonical dual-value hash lookup (see hash_index.CanonicalHashArrays):
    ONE t1 row gather per position answers both strands.

    With do_rc returns (ix_fwd_or_rc_a, ix_b): two (B, W) int32 matrices whose
    concatenation is the exact reference hit multiset of the fwd+RC scan.
    Without RC returns one matrix of forward-strand hits only."""
    t1, t2 = tables["c1"], tables["c2"]
    t3 = tables.get("c3")
    b1, b2 = t1.shape[0], t2.shape[0]
    cps = 4 if wide else 3
    # jnp silently CLAMPS static out-of-bounds column indices, so a slot
    # mismatch would mis-probe instead of erroring — reject it here
    if t1.shape[1] != slots * cps or t2.shape[1] != slots2 * cps:
        raise ValueError("slot count does not match table geometry")

    key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
    bkt1, bkt2 = canonical_buckets(key_lo, key_hi, valid, b1, b2)
    if wide:
        va, vb = probe_rows_wide(t1[bkt1], key_lo, key_hi, slots)
        if b2 > 8:
            va2, vb2 = probe_rows_wide(t2[bkt2], key_lo, key_hi, slots2)
            miss = (va | vb) == 0
            va = jnp.where(miss, va2, va)
            vb = jnp.where(miss, vb2, vb)
        if t3 is not None and t3.shape[0] > 8:
            slots3 = t3.shape[1] // cps
            bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
            va3, vb3 = probe_rows_wide(t3[bkt3], key_lo, key_hi, slots3)
            miss = (va | vb) == 0
            va = jnp.where(miss, va3, va)
            vb = jnp.where(miss, vb3, vb)
        return decode_canonical_wide(va, vb, valid, fwd_le, bad_ix, do_rc)
    val = probe_rows(t1[bkt1], key_lo, key_hi, slots)
    if b2 > 8:  # spill probe (narrow rows; index derives from the key, so
        # all levels' gathers are independent and pipeline)
        val = jnp.where(val != 0, val, probe_rows(t2[bkt2], key_lo, key_hi, slots2))
    if t3 is not None and t3.shape[0] > 8:  # 3-level tier: tiny cached tail
        slots3 = t3.shape[1] // 3
        bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
        val = jnp.where(val != 0, val, probe_rows(t3[bkt3], key_lo, key_hi, slots3))
    return decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)


def extract_windows64(codes: jax.Array):
    """Slide 64-mers: lanes (k0, k1, k2, k3) int32 MSB-first (k0 = bases
    0..15, ..., k3 = bases 48..63) + validity.  Built by pairing the 32-mer
    lanes at offsets i and i+32 — no second extraction pass."""
    qpre, qhi, qlo, valid = extract_windows(codes, 32)
    w = qpre.shape[1]
    if w <= 32:
        raise ValueError("reads shorter than 64 after padding")
    w64 = w - 32
    top = (qpre.astype(jnp.uint32) << jnp.uint32(8)) | qhi.astype(jnp.uint32)
    k0 = jax.lax.bitcast_convert_type(top[:, :w64], jnp.int32)
    k1 = jax.lax.bitcast_convert_type(qlo[:, :w64].astype(jnp.uint32), jnp.int32)
    k2 = jax.lax.bitcast_convert_type(top[:, 32:], jnp.int32)
    k3 = jax.lax.bitcast_convert_type(qlo[:, 32:].astype(jnp.uint32), jnp.int32)
    return k0, k1, k2, k3, valid[:, :w64] & valid[:, 32:]


def rc_lanes64(k0, k1, k2, k3):
    """128-bit reverse complement on 4 int32 lanes (lane mirror + per-lane
    complement-reverse)."""
    c = lambda x: jax.lax.bitcast_convert_type(
        _rev2_32(~jax.lax.bitcast_convert_type(x, jnp.uint32)), jnp.int32
    )
    return c(k3), c(k2), c(k1), c(k0)


def _canonicalize64(k0, k1, k2, k3):
    """Lex-min of (word, RC) on four int32 lanes -> (c0..c3, fwd_le)."""
    r0, r1, r2, r3 = rc_lanes64(k0, k1, k2, k3)

    def u(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint32)

    def lex_le(a, b):
        le = u(a[3]) <= u(b[3])
        for i in (2, 1, 0):
            le = (u(a[i]) < u(b[i])) | ((u(a[i]) == u(b[i])) & le)
        return le

    fwd_le = lex_le((k0, k1, k2, k3), (r0, r1, r2, r3))
    c0 = jnp.where(fwd_le, k0, r0)
    c1 = jnp.where(fwd_le, k1, r1)
    c2 = jnp.where(fwd_le, k2, r2)
    c3 = jnp.where(fwd_le, k3, r3)
    return c0, c1, c2, c3, fwd_le


def _probe64(table, bucket, nslots, c0, c1, c2, c3):
    """Match four key lanes over a row of nslots 6-col entries -> (va, vb)."""
    rows = table[bucket]
    va = jnp.zeros(bucket.shape, jnp.int32)
    vb = jnp.zeros(bucket.shape, jnp.int32)
    for s in range(nslots):
        m = (
            (rows[..., s * 6] == c0)
            & (rows[..., s * 6 + 1] == c1)
            & (rows[..., s * 6 + 2] == c2)
            & (rows[..., s * 6 + 3] == c3)
            & ((rows[..., s * 6 + 4] | rows[..., s * 6 + 5]) != 0)
        )
        va = jnp.where(m, rows[..., s * 6 + 4], va)
        vb = jnp.where(m, rows[..., s * 6 + 5], vb)
    return va, vb


def lookup_kmers_canonical64(tables: dict, k0, k1, k2, k3, valid, *,
                             slots: int, slots2: int, miss: int, do_rc: bool):
    """64-mer canonical dual-value hash lookup (hash_index64).  Returns
    (ix_a, ix_b) when do_rc else the forward-strand matrix; `miss` must be
    >= num_labels and fit int32 (the histogram only tests ix < num_labels)."""
    from utree_tpu.hash_index64 import mix4

    t1, t2 = tables["c64_1"], tables["c64_2"]
    t3 = tables.get("c64_3")
    b1, b2 = t1.shape[0], t2.shape[0]
    if t1.shape[1] != slots * 6 or t2.shape[1] != slots2 * 6:
        raise ValueError("slot count does not match table geometry")

    c0, c1, c2, c3, fwd_le = _canonicalize64(k0, k1, k2, k3)

    def u(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint32)

    def probe(table, bucket, nslots):
        rows = table[bucket]
        va = jnp.zeros(bucket.shape, jnp.int32)
        vb = jnp.zeros(bucket.shape, jnp.int32)
        for s in range(nslots):
            m = (
                (rows[..., s * 6] == c0)
                & (rows[..., s * 6 + 1] == c1)
                & (rows[..., s * 6 + 2] == c2)
                & (rows[..., s * 6 + 3] == c3)
                & ((rows[..., s * 6 + 4] | rows[..., s * 6 + 5]) != 0)
            )
            va = jnp.where(m, rows[..., s * 6 + 4], va)
            vb = jnp.where(m, rows[..., s * 6 + 5], vb)
        return va, vb

    h1 = mix4(u(c0), u(c1), u(c2), u(c3), 0, jnp.uint32)
    hb = mix4(u(c0), u(c1), u(c2), u(c3), 0x6A09E667, jnp.uint32)
    g = h1 ^ ((hb << jnp.uint32(15)) | (hb >> jnp.uint32(17)))
    bkt1 = jnp.where(valid, (g & jnp.uint32(b1 - 1)).astype(jnp.int32), 0)
    va, vb = probe(t1, bkt1, slots)
    if b2 > 8:
        h2 = mix4(u(c0), u(c1), u(c2), u(c3), 0x5BD1E995, jnp.uint32)
        bkt2 = jnp.where(valid, (h2 & jnp.uint32(b2 - 1)).astype(jnp.int32), 0)
        va2, vb2 = probe(t2, bkt2, slots2)
        hit1 = (va | vb) != 0
        va = jnp.where(hit1, va, va2)
        vb = jnp.where(hit1, vb, vb2)
    if t3 is not None and t3.shape[0] > 8:  # 3-level tier: tiny cached tail
        h3 = mix4(u(c0), u(c1), u(c2), u(c3), 0x27D4EB2F, jnp.uint32)
        bkt3 = jnp.where(valid, (h3 & jnp.uint32(t3.shape[0] - 1)).astype(jnp.int32), 0)
        va3, vb3 = probe(t3, bkt3, t3.shape[1] // 6)
        hit = (va | vb) != 0
        va = jnp.where(hit, va, va3)
        vb = jnp.where(hit, vb, vb3)
    if do_rc:
        ix_a = jnp.where(valid & (va > 0), va - 1, miss)
        ix_b = jnp.where(valid & (vb > 0), vb - 1, miss)
        return ix_a, ix_b
    fwd = jnp.where(fwd_le, va, vb)
    return jnp.where(valid & (fwd > 0), fwd - 1, miss)


def lookup_kmers_displaced64(tables: dict, k0, k1, k2, k3, valid, *,
                             miss: int, do_rc: bool):
    """64-mer seeded-displacement lookup (hash_index64.Displaced64Arrays):
    cached u8 seed read + ONE 2-slot 48B row gather answers both strands;
    cached t3 tail for placement spill.  Builder twins:
    displaced_buckets64_np (bucket) and place_displaced_core's _disp_slot_np
    over mix4 u2/u3 lanes (slot)."""
    from utree_tpu.hash_index64 import mix4

    t1, seeds = tables["d64_1"], tables["d64_s"]
    t3 = tables.get("d64_3")
    if t1.shape[1] != 12:
        raise ValueError("displaced64 t1 must have 2-slot rows")
    nslots = 2 * t1.shape[0]
    nseed = 4 * seeds.shape[0]

    c0, c1, c2, c3, fwd_le = _canonicalize64(k0, k1, k2, k3)

    def u(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint32)

    h1 = mix4(u(c0), u(c1), u(c2), u(c3), 0, jnp.uint32)
    hb = mix4(u(c0), u(c1), u(c2), u(c3), 0x6A09E667, jnp.uint32)
    g = h1 ^ ((hb << jnp.uint32(15)) | (hb >> jnp.uint32(17)))
    bkt = jnp.where(valid, (g & jnp.uint32(nseed - 1)).astype(jnp.int32), 0)
    seed = displaced_seed_jnp(seeds, bkt)
    u2 = mix4(u(c0), u(c1), u(c2), u(c3), 0x94D049BB, jnp.uint32)
    u3 = mix4(u(c0), u(c1), u(c2), u(c3), 0x7FEB352D, jnp.uint32)
    h = ((u2 ^ (seed * jnp.uint32(0x85EBCA6B))) * jnp.uint32(0xC2B2AE35)
         ^ (u3 ^ (seed * jnp.uint32(0xC2B2AE35))) * jnp.uint32(0x85EBCA6B))
    slot = jnp.where(valid, (h % jnp.uint32(nslots)).astype(jnp.int32), 0)
    va, vb = _probe64(t1, slot >> 1, 2, c0, c1, c2, c3)
    if t3 is not None and t3.shape[0] > 8:
        h3 = mix4(u(c0), u(c1), u(c2), u(c3), 0x27D4EB2F, jnp.uint32)
        bkt3 = jnp.where(valid, (h3 & jnp.uint32(t3.shape[0] - 1)).astype(jnp.int32), 0)
        va3, vb3 = _probe64(t3, bkt3, t3.shape[1] // 6, c0, c1, c2, c3)
        hit = (va | vb) != 0
        va = jnp.where(hit, va, va3)
        vb = jnp.where(hit, vb, vb3)
    if do_rc:
        ix_a = jnp.where(valid & (va > 0), va - 1, miss)
        ix_b = jnp.where(valid & (vb > 0), vb - 1, miss)
        return ix_a, ix_b
    fwd = jnp.where(fwd_le, va, vb)
    return jnp.where(valid & (fwd > 0), fwd - 1, miss)


def window_lanes(reads_u8: jax.Array, lengths: jax.Array, k: int, do_rc: bool):
    """ASCII reads -> per-window (qpre, qhi, qlo, valid) lanes, forward
    followed by arithmetic RC words (k=32)."""
    codes = base_codes(reads_u8, lengths)
    if do_rc and k != 32:
        codes = append_rc(codes, lengths)
    qpre, qhi, qlo, valid = extract_windows(codes, k)
    if do_rc and k == 32:
        rpre, rhi, rlo = rc_word_lanes(qpre, qhi, qlo)
        qpre = jnp.concatenate([qpre, rpre], axis=1)
        qhi = jnp.concatenate([qhi, rhi], axis=1)
        qlo = jnp.concatenate([qlo, rlo], axis=1)
        valid = jnp.concatenate([valid, valid], axis=1)
    return qpre, qhi, qlo, valid


def search_step(table: dict, reads_u8: jax.Array, lengths: jax.Array, *,
                k: int, do_rc: bool, probe_iters: int, bad_ix: int,
                hash_slots: int = 8, num_labels: int | None = None):
    """Full device step: ASCII reads -> per-window label ids (bad_ix = miss).
    Dispatches to the canonical path ("c1": one probe answers both strands)
    or the hash path ("t1"); RC words otherwise derive arithmetically from
    the forward lanes (k=32).  `num_labels` is required for canonical tables
    (it selects the narrow/wide entry layout)."""
    if ("c1" in table or "d1" in table) and k == 32:
        if num_labels is None:
            raise ValueError("num_labels is required for canonical tables")
        codes = base_codes(reads_u8, lengths)
        qpre, qhi, qlo, valid = extract_windows(codes, k)
        return _canonical_family_ix(table, qpre, qhi, qlo, valid,
                                    bad_ix=bad_ix, do_rc=do_rc,
                                    num_labels=num_labels)
    if ("c64_1" in table or "d64_1" in table) and k == 64:
        codes = base_codes(reads_u8, lengths)
        k0, k1, k2, k3, valid = extract_windows64(codes)
        if "d64_1" in table:
            r = lookup_kmers_displaced64(
                table, k0, k1, k2, k3, valid,
                miss=min(bad_ix, 0x7FFFFFFF), do_rc=do_rc)
        else:
            r = lookup_kmers_canonical64(
                table, k0, k1, k2, k3, valid,
                slots=table["c64_1"].shape[1] // 6,
                slots2=table["c64_2"].shape[1] // 6,
                miss=min(bad_ix, 0x7FFFFFFF), do_rc=do_rc)
        return jnp.concatenate(r, axis=1) if do_rc else r
    qpre, qhi, qlo, valid = window_lanes(reads_u8, lengths, k, do_rc)
    if "t1" in table:
        return lookup_kmers_hash(table, qpre, qhi, qlo, valid,
                                 slots=hash_slots, bad_ix=bad_ix)
    return lookup_kmers(table, qpre, qhi, qlo, valid, probe_iters, bad_ix)


def compact_histogram(ix_mat: jax.Array, num_labels: int, cap: int):
    """Per-read sparse hit histograms, fixed width.

    ix_mat (B, W) holds per-window label ids (misses >= num_labels).  Returns
      labels (B, cap) int32   unique hit ids, ascending; unused slots = -1
      counts (B, cap) int32   multiplicities
      nuniq  (B,)     int32   TRUE unique count (> cap means overflow: the
                              caller must reprocess that read another way)
      found  (B,)     int32   total hits (foundUniq, itree.c:929-930)
    The aufbau vote needs only this histogram (itree.c:1033-1041), so this is
    the natural device/host cut point — it shrinks the device->host transfer
    by ~W/cap while staying exact for reads with <= cap unique labels."""
    b, w = ix_mat.shape
    big = jnp.int32(0x7FFFFFFF)
    hit = ix_mat < num_labels
    found = jnp.sum(hit, axis=1, dtype=jnp.int32)
    key = jnp.where(hit, ix_mat, big)
    # iterative unique extraction: `cap` rounds of (min, count) reductions,
    # each a fused elementwise+reduce pass over (B, W) with no sort and no
    # scatter.  Whether a segmented sort beats it for a given cap is open.
    labels_list = []
    counts_list = []
    cur = jnp.full((b, 1), -1, jnp.int32)
    for _ in range(cap):
        cand = jnp.where(key > cur, key, big)
        m = jnp.min(cand, axis=1, keepdims=True)
        cnt = jnp.sum(key == m, axis=1, dtype=jnp.int32)
        labels_list.append(jnp.where(m[:, 0] < big, m[:, 0], -1))
        counts_list.append(jnp.where(m[:, 0] < big, cnt, 0))
        cur = m
    labels = jnp.stack(labels_list, axis=1)
    counts = jnp.stack(counts_list, axis=1)
    used = jnp.sum(labels >= 0, axis=1, dtype=jnp.int32)
    # overflow: any hit label beyond the last extracted slot
    overflow = jnp.any(jnp.where(key > cur, key, big) < big, axis=1)
    nuniq = jnp.where(overflow, cap + 1, used)
    return labels, counts, nuniq, found


def search_step_hist(table: dict, reads_u8: jax.Array, lengths: jax.Array, *,
                     k: int, do_rc: bool, probe_iters: int, bad_ix: int,
                     num_labels: int, cap: int = 16):
    """search_step + on-device per-read histogram compaction.

    Returns ONE (B, 2*cap+2) int32 array — [labels | counts | nuniq | found]
    per row — so the host pulls a single buffer per batch."""
    ix = search_step(table, reads_u8, lengths, k=k, do_rc=do_rc,
                     probe_iters=probe_iters, bad_ix=bad_ix)
    labels, counts, nuniq, found = compact_histogram(ix, num_labels, cap)
    return jnp.concatenate(
        [labels, counts, nuniq[:, None], found[:, None]], axis=1
    )


def _packed_window_ix(table: dict, packed: jax.Array, vbits: jax.Array,
                      lengths: jax.Array, *,
                      k: int, do_rc: bool, probe_iters: int, bad_ix: int,
                      num_labels: int, true_len: int | None):
    """Shared front half of the packed-input steps: 2-bit-packed reads ->
    per-window label ids (misses >= num_labels).

    true_len (static, multiple of 8, >= every row length) trims the window
    count to the batch's real maximum read length instead of the transfer
    buffer's padded width — windows past it are all-invalid anyway, and every
    per-window cost (gather, probe, histogram) is linear in W."""
    if true_len is not None and true_len < packed.shape[1] * 4:
        packed = packed[:, : true_len // 4]
        vbits = vbits[:, : true_len // 8]
    codes = base_codes_packed(packed, vbits, lengths)
    qpre, qhi, qlo, valid = extract_windows(codes, k)
    if "c1" in table or "d1" in table:  # canonical family: one probe, both strands
        return _canonical_family_ix(table, qpre, qhi, qlo, valid,
                                    bad_ix=bad_ix, do_rc=do_rc,
                                    num_labels=num_labels)
    if do_rc:
        if k != 32:
            raise NotImplementedError("packed path implements k=32")
        rpre, rhi, rlo = rc_word_lanes(qpre, qhi, qlo)
        qpre = jnp.concatenate([qpre, rpre], axis=1)
        qhi = jnp.concatenate([qhi, rhi], axis=1)
        qlo = jnp.concatenate([qlo, rlo], axis=1)
        valid = jnp.concatenate([valid, valid], axis=1)
    if "t1" in table:
        return lookup_kmers_hash(table, qpre, qhi, qlo, valid, slots=8, bad_ix=bad_ix)
    return lookup_kmers(table, qpre, qhi, qlo, valid, probe_iters, bad_ix)


def search_step_hist_packed(table: dict, packed: jax.Array, vbits: jax.Array,
                            lengths: jax.Array, *,
                            k: int, do_rc: bool, probe_iters: int, bad_ix: int,
                            num_labels: int, cap: int = 16,
                            true_len: int | None = None):
    """2-bit-packed-input variant with a u16-packed output: (B, cap+1) int32
    where col j<cap = (label+1) | count<<16 and col cap = nuniq | found<<5.
    Requires window counts < 2^16 (reads < ~32Kb; longer reads take the
    chunked long-read path) and num_labels < 2^16-1."""
    ix = _packed_window_ix(table, packed, vbits, lengths, k=k, do_rc=do_rc,
                           probe_iters=probe_iters, bad_ix=bad_ix,
                           num_labels=num_labels, true_len=true_len)
    return pack_hist(ix, num_labels, cap)


def search_step_hist_compact(table: dict, packed: jax.Array, vbits: jax.Array,
                             lengths: jax.Array, *,
                             k: int, do_rc: bool, probe_iters: int, bad_ix: int,
                             num_labels: int, cap: int = 16, over_cap: int = 0,
                             true_len: int | None = None):
    """search_step_hist_packed with the COMPACT readback layout — a smaller
    device->host copy: most reads hit <= 1 label and need only 8 of the
    (B, cap+1) histogram row's 36 bytes.

    Returns ONE flat int32 vector of 2*B + (over_cap+1)*(cap+1) elements:
      [0, 2B)   per-read pairs (tail, lc0): tail = nuniq | found<<5 exactly
                as pack_hist's last column; lc0 = the first histogram slot
                ((label+1) | count<<16) — the whole story for nuniq <= 1.
      rest      an (over_cap+1, cap+1) overflow block: row 0 col 0 = n_over,
                the TRUE count of reads with nuniq >= 2; rows 1..n_over are
                (read_id, lc[0..cap-1]) for those reads in read order.
    If n_over > over_cap the extra rows are dropped on device and the host
    must redispatch the batch through the full (B, cap+1) layout — exactness
    is never lost, the compact path just stops paying off for such batches
    (pipeline.SearchPipeline._to_host handles this)."""
    ix = _packed_window_ix(table, packed, vbits, lengths, k=k, do_rc=do_rc,
                           probe_iters=probe_iters, bad_ix=bad_ix,
                           num_labels=num_labels, true_len=true_len)
    labels, counts, nuniq, found = compact_histogram(ix, num_labels, cap)
    lc = (labels + 1) | (counts << 16)
    tail = nuniq | (found << 5)
    b = lc.shape[0]
    main = jnp.stack([tail, lc[:, 0]], axis=1)  # (B, 2)
    flag = nuniq >= 2  # includes the cap+1 overflow sentinel
    pos = jnp.cumsum(flag.astype(jnp.int32)) - 1
    n_over = jnp.sum(flag.astype(jnp.int32))
    # rows beyond the block's capacity scatter out of bounds and are dropped;
    # the header count still records the true total so the host can tell
    dest = jnp.where(flag & (pos < over_cap), pos + 1, over_cap + 1)
    rows = jnp.concatenate(
        [jnp.arange(b, dtype=jnp.int32)[:, None], lc], axis=1)
    over = jnp.zeros((over_cap + 1, cap + 1), jnp.int32)
    over = over.at[dest].set(rows, mode="drop")
    over = over.at[0, 0].set(n_over)
    return jnp.concatenate([main.reshape(-1), over.reshape(-1)])


def search_step_vote_compact(table: dict, packed: jax.Array, vbits: jax.Array,
                             lengths: jax.Array, *,
                             k: int, do_rc: bool, probe_iters: int, bad_ix: int,
                             num_labels: int, cap: int,
                             taxacut: int, max_iters: int,
                             true_len: int | None = None):
    """search_step_hist_compact with the AUFBAU RUN ON DEVICE
    (classify_device.aufbau_walk_device): the readback is a flat (B*3,)
    int32 vector, 12B/read with NO per-read histogram rows —
      w0 = (rep_label+1) | nuniq<<17 | dvcode<<22 | flag<<24
      w1 = foundUniq | dv<<20
      w2 = sl | ol<<16
    Reads with flag set (nuniq > cap, or the defensive walk-iteration cap)
    carry no vote; the host recomputes their histograms exactly and walks
    them in C (utree_format_device_vote's override CSR) — the same
    cap-overflow contract as the histogram layouts.  Field ranges are
    guaranteed by the pipeline gates: num_labels < 2^16 (packed lanes),
    reads <= long_read_threshold so found < 2^16, label strings < 2048
    chars so dv fits 11 bits."""
    from utree_tpu.classify_device import DV_INTERP, aufbau_walk_device

    vote_tab = {kk[3:]: v for kk, v in table.items() if kk.startswith("vt_")}
    ix = _packed_window_ix(table, packed, vbits, lengths, k=k, do_rc=do_rc,
                           probe_iters=probe_iters, bad_ix=bad_ix,
                           num_labels=num_labels, true_len=true_len)
    labels, counts, nuniq, found = compact_histogram(ix, num_labels, cap)
    rep, dvcode, dv, sl, ol, flag = aufbau_walk_device(
        vote_tab, labels, counts, nuniq, found, taxacut=taxacut,
        max_iters=max_iters)
    # value-range insurance: a read whose counters exceed the packed field
    # widths (possible only far beyond the short-read threshold) is flagged
    # for the exact host replay instead of being truncated
    unfit = ((found >= (1 << 20)) | (sl >= (1 << 16)) | (ol >= (1 << 16))
             | ((dvcode == DV_INTERP) & (dv >= (1 << 11))))
    flag = flag | unfit.astype(jnp.int32)
    w0 = ((rep + 1) | (jnp.minimum(nuniq, 31) << 17) | (dvcode << 22)
          | (flag << 24))
    w1 = found | (jnp.where(dvcode == DV_INTERP, dv, 0) << 20)
    w2 = sl | (ol << 16)
    return jnp.stack([w0, w1, w2], axis=1)  # (B, 3): row-shardable over data


def pack_hist(ix: jax.Array, num_labels: int, cap: int) -> jax.Array:
    """compact_histogram + u16 packing: (B, W) ids -> (B, cap+1) int32 where
    col j<cap = (label+1) | count<<16 and col cap = nuniq | found<<5."""
    labels, counts, nuniq, found = compact_histogram(ix, num_labels, cap)
    lc = (labels + 1) | (counts << 16)
    tail = nuniq | (found << 5)
    return jnp.concatenate([lc, tail[:, None]], axis=1)


def search_step_hist_packed_in(table: dict, packed: jax.Array,
                               vbits: jax.Array, lengths: jax.Array, *,
                               k: int, do_rc: bool, probe_iters: int,
                               bad_ix: int, num_labels: int, cap: int = 16,
                               true_len: int | None = None):
    """2-bit-packed INPUT with the UNPACKED int32 histogram output
    (B, 2*cap+2 = [labels | counts | nuniq | found]) — the layout for
    IXTYPE=u32 DBs whose label ids do not fit the u16-packed output but
    whose reads still deserve the 2.7x-smaller transfer."""
    ix = _packed_window_ix(table, packed, vbits, lengths, k=k, do_rc=do_rc,
                           probe_iters=probe_iters, bad_ix=bad_ix,
                           num_labels=num_labels, true_len=true_len)
    labels, counts, nuniq, found = compact_histogram(ix, num_labels, cap)
    return jnp.concatenate(
        [labels, counts, nuniq[:, None], found[:, None]], axis=1)


def lookup_kmers_displaced(tables: dict, qpre, qhi, qlo, valid, *,
                           bad_ix: int, do_rc: bool, wide: bool = False):
    """Seeded-displacement canonical lookup (hash_index.DisplacedHashArrays):
    a scalar u8 seed gather from the small seed table, then ONE 2-slot row
    gather whose index depends on it (the 3-level chain needs two row
    gathers)."""
    key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
    r = displaced_probe_raw(tables, key_lo, key_hi, valid, wide=wide)
    if wide:
        return decode_canonical_wide(r[0], r[1], valid, fwd_le, bad_ix, do_rc)
    return decode_canonical_vals(r, valid, fwd_le, bad_ix, do_rc)


def displaced_bucket_jnp(key_lo, key_hi, valid, nseed: int):
    """Seed-bucket of each key lane: the folded two-mix hash (builder twin:
    hash_index.displaced_buckets_np)."""
    c_lo = key_lo.astype(jnp.uint32)
    c_hi32 = key_hi.astype(jnp.uint32)
    c_pre = (c_hi32 >> jnp.uint32(8)).astype(jnp.int32)
    c_hi8 = (c_hi32 & jnp.uint32(0xFF)).astype(jnp.int32)
    h1 = _mix_jnp(c_pre, c_hi8, c_lo)
    hb = _mix_jnp(c_pre, c_hi8, c_lo ^ jnp.uint32(0x6A09E667))
    gfold = h1 ^ ((hb << jnp.uint32(15)) | (hb >> jnp.uint32(17)))
    return jnp.where(valid, (gfold & jnp.uint32(nseed - 1)).astype(jnp.int32), 0)


def displaced_seed_jnp(seeds, bkt):
    """u8 seed of each bucket lane from the packed-int32 seed words."""
    word = seeds[bkt >> 2]
    return (
        jax.lax.bitcast_convert_type(word, jnp.uint32)
        >> ((bkt & 3) << 3).astype(jnp.uint32)
    ) & jnp.uint32(0xFF)


def displaced_slot_jnp(key_lo, key_hi, seed, valid, nslots: int):
    """t1 slot of each (key, seed) lane (builder twin: _disp_slot_np).  Two
    independent key-mix lanes feed the seed mix — see _disp_slot_np for why
    one lane deadlocks the placement at scale."""
    c_lo = key_lo.astype(jnp.uint32)
    c_hi32 = key_hi.astype(jnp.uint32)
    c_pre = (c_hi32 >> jnp.uint32(8)).astype(jnp.int32)
    c_hi8 = (c_hi32 & jnp.uint32(0xFF)).astype(jnp.int32)
    u2 = _mix_jnp(c_pre, c_hi8, c_lo ^ jnp.uint32(0x94D049BB))
    ub = _mix_jnp(c_pre, c_hi8 ^ jnp.int32(0xA5), c_lo ^ jnp.uint32(0x7FEB352D))
    h = ((u2 ^ (seed * jnp.uint32(0x85EBCA6B))) * jnp.uint32(0xC2B2AE35)
         ^ (ub ^ (seed * jnp.uint32(0xC2B2AE35))) * jnp.uint32(0x85EBCA6B))
    return jnp.where(valid, (h % jnp.uint32(nslots)).astype(jnp.int32), 0)


def displaced_probe_raw(tables: dict, key_lo, key_hi, valid, *, wide: bool):
    """Core displaced probe on generic (lo32, hi32) key lanes: scalar seed
    gather -> one 2-slot row gather -> cached t3 tail.  Returns the raw
    packed value (narrow) or (va, vb) int32 pair (wide); 0 = miss."""
    t1, seeds = tables["d1"], tables["ds"]
    t3 = tables.get("d3")
    cps = 4 if wide else 3
    if t1.shape[1] != 2 * cps:
        raise ValueError("displaced t1 must have 2-slot rows")
    nslots = 2 * t1.shape[0]
    nseed = 4 * seeds.shape[0]

    bkt = displaced_bucket_jnp(key_lo, key_hi, valid, nseed)
    seed = displaced_seed_jnp(seeds, bkt)
    slot = displaced_slot_jnp(key_lo, key_hi, seed, valid, nslots)
    rows = t1[slot >> 1]
    if wide:
        va, vb = probe_rows_wide(rows, key_lo, key_hi, 2)
        if t3 is not None and t3.shape[0] > 8:
            bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
            va3, vb3 = probe_rows_wide(t3[bkt3], key_lo, key_hi,
                                       t3.shape[1] // cps)
            miss = (va | vb) == 0
            va = jnp.where(miss, va3, va)
            vb = jnp.where(miss, vb3, vb)
        return va, vb
    val = probe_rows(rows, key_lo, key_hi, 2)
    if t3 is not None and t3.shape[0] > 8:
        bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
        val = jnp.where(val != 0, val,
                        probe_rows(t3[bkt3], key_lo, key_hi, t3.shape[1] // 3))
    return val


def _canonical_family_ix(table: dict, qpre, qhi, qlo, valid, *,
                         bad_ix: int, do_rc: bool, num_labels: int):
    """Dispatch the canonical-key table layouts ('c1' ladder / 'd1'
    displaced) to per-window ids; concatenates the RC lanes."""
    wide = num_labels >= 0xFFFF
    cps = 4 if wide else 3
    if "d1" in table:
        r = lookup_kmers_displaced(table, qpre, qhi, qlo, valid,
                                   bad_ix=bad_ix, do_rc=do_rc, wide=wide)
    else:
        r = lookup_kmers_canonical(table, qpre, qhi, qlo, valid,
                                   slots=table["c1"].shape[1] // cps,
                                   slots2=table["c2"].shape[1] // cps,
                                   bad_ix=bad_ix, do_rc=do_rc, wide=wide)
    return jnp.concatenate(r, axis=1) if do_rc else r
