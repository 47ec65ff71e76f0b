"""End-to-end batched search pipeline (device lookup/histogram + host vote).

Replaces the reference's thread-per-read search (XT_doSearch32 under
`#pragma omp parallel`, itree.c:1009-1101) with:

  host: pack reads into fixed-shape uint8 batches (length-bucketed) ->
  device (one jitted program): base-coding, RC append, window packing,
        flat-table lookup, per-read sparse histogram compaction ->
  host: aufbau vote + line formatting (classify.py) from the tiny
        (labels, counts) histograms; reads whose unique-label count exceeds
        the device cap (rare) are recomputed exactly on host.

Batches are dispatched asynchronously (JAX dispatch is non-blocking), so
host<->device transfers overlap device compute and the host vote of the
previous batch — the pipeline-parallel analog of the reference's
reader-thread/worker-thread split (itree.c:867-875).

Output lines are emitted in read order, equal to the single-threaded
reference binary's output (multithreading only permutes its line order).
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import jax
import numpy as np

from utree_tpu.classify import aufbau_vote_counts
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.io.fasta import iter_fasta_records
from utree_tpu.lookup import search_step_hist


# auto lookup-mode may silently fall back to the bsearch-replay path only
# below this record count: the replay's ~10 dependent gathers per k-mer are
# tolerable for small DBs, while at L2+ density auto mode must surface an
# error pointing at the routed multi-device remedy instead
_REPLAY_AUTO_MAX = 80_000_000
# auto mode's layout crossovers (tuning choices, open to a sweep on the
# target device): the displaced table from this many records up, and no
# single-device hash table from _HASH_AUTO_MAX up
_DISPLACED_AUTO_MIN = 80_000_000
_HASH_AUTO_MAX = 400_000_000


def _bucket_len(n: int, minimum: int = 64) -> int:
    """Round length up to a power of two to bound jit recompiles."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_len64(n: int, minimum: int = 64) -> int:
    """Round length up to a multiple of 64 (pow2 above 2048).

    Window count — and so lookup cost — is linear in the padded length, and
    typical read files hold one or two distinct lengths, so the finer
    granularity saves real gathers (150bp -> 192 pad = 161 windows vs 225)
    while recompiles stay bounded."""
    if n > 2048:
        return _bucket_len(n, 4096)
    return max(minimum, (n + 63) & ~63)


@dataclasses.dataclass
class SearchPipeline:
    index: DeviceIndexArrays
    do_rc: bool = False
    batch_size: int = 8192
    # rounds of on-device histogram extraction (lookup.compact_histogram):
    # each round is a full reduction pass over the batch's windows, and reads
    # with more unique labels (rare: a read hits ~1-2 genomes) are recomputed
    # exactly on host via the overflow path
    hist_cap: int = 8
    lookup_mode: str = "auto"  # auto|canonical|displaced|routed|hash|bsearch
    support_ranges: int = 1  # 8 = README-documented per-rank pairs (host vote)
    # devices > 1: single-host multi-device DP — the table is replicated into
    # every device's memory and read batches shard over a `data` mesh axis
    # (the device answer to the reference's node-saturating OpenMP loop,
    # itree.c:1009).  Output bytes are identical at any device count.
    devices: int | None = None
    _table: dict = None

    # compact readback: the device returns 8B/read (tail + first histogram
    # slot) plus a fixed-capacity block of full rows for reads with >= 2
    # unique labels, instead of the full (B, cap+1) matrix — a ~2.8x smaller
    # device->host copy.  Batches whose >=2-label reads exceed the block
    # capacity (batch_size/8) are redispatched through the full layout, so
    # output bytes are identical either way.  Single-device packed-u16 path
    # only.
    compact_readback: bool = True
    compact_over_cap: int | None = None  # tests: force the redispatch path

    # aufbau on device (classify_device): the vote itself runs on the device
    # and the readback is 12B/read with no histogram rows at all — the host
    # only formats lines.  Engaged when the packed-u16 single-device path is
    # active, the native formatter compiled, and label strings fit the
    # packed field widths; falls back to compact_readback otherwise.
    device_vote: bool = True

    use_native_vote: bool = True
    # optional utils.trace.PhaseTimer: search_file accumulates per-phase time
    # (scan/pack/dispatch/drain+vote/write) + a `reads` count into it — the
    # framework's answer to the reference's omp_get_wtime narration
    # (xtree.c:289-473; itree.c:878 progress lines)
    tracer: object = None

    def __post_init__(self):
        cfg = self.index.config
        # the packed device output stores nuniq in a 5-bit lane with cap+1 as
        # the overflow sentinel (lookup.pack_hist; host unpacks tail & 31), so
        # cap > 30 silently corrupts results and cap < 1 has no histogram rows
        if not 1 <= self.hist_cap <= 30:
            raise ValueError(
                f"hist_cap={self.hist_cap} out of range: the packed device "
                "histogram carries nuniq in 5 bits (valid caps are 1..30)")
        self._mesh = None
        self._repl = self._data = None
        self._compact = False
        self._devvote = False
        self._step_jit = None  # mesh mode's jitted main step (compiled_step)
        self._routed = self.lookup_mode == "routed"
        if self._routed:
            # table SHARDED over the devices (the bigger-than-one-device
            # regime: the reference's ~1.2G-record CTR in one node's RAM,
            # itree.c:733-828) instead of replicated into each
            if not (self.devices and self.devices > 1):
                raise ValueError("--lookup-mode routed requires --devices N > 1")
            if cfg.packsize != 32:
                raise ValueError("routed mode implements PACKSIZE=32")
            if self.index.num_labels >= 0xFFFF:
                raise ValueError(
                    "routed pipeline mode packs label ids into u16 lanes; "
                    "IXTYPE=u32 DBs with >= 65534 labels need the replicated "
                    "table (devices mode without --lookup-mode routed)")
        if self.devices and self.devices > 1:
            from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

            devs = jax.devices()
            if len(devs) < self.devices:
                raise ValueError(
                    f"--devices {self.devices} requested but only "
                    f"{len(devs)} present")
            if self.batch_size % self.devices:
                raise ValueError("batch_size must be divisible by devices")
            if self._routed:
                self._mesh = Mesh(
                    np.array(devs[: self.devices]).reshape(1, self.devices),
                    ("data", "table"))
            else:
                self._mesh = Mesh(np.array(devs[: self.devices]), ("data",))
            self._repl = NamedSharding(self._mesh, P())
            self._data = NamedSharding(self._mesh, P("data"))
        # byte cap for each table array, from the device it is placed onto
        from utree_tpu import memory

        self._t1_cap = memory.table_budget(
            self._mesh.devices.flat[0] if self._mesh is not None
            else jax.devices()[0])
        if self._routed:
            from utree_tpu.parallel.routed import (
                ShardedDisplacedIndex,
                routed_displaced_fallback_step,
                routed_displaced_search_step,
            )

            sharded = ShardedDisplacedIndex.build(self.index, self.devices,
                                                  t1_cap=self._t1_cap)
            self._table = sharded.device_put(self._mesh)
            kw = dict(do_rc=self.do_rc, num_labels=self.index.num_labels,
                      cap=self.hist_cap, bad_ix=cfg.bad_ix)
            self._step_routed = routed_displaced_search_step(
                self._mesh, sharded, **kw)
            self._fallback_step = routed_displaced_fallback_step(
                self._mesh, sharded, **kw)
            # FIFO of in-flight (packed, vbits, lens): consumed by _to_host in
            # dispatch order so a flagged capacity overflow can redispatch the
            # batch through the exact broadcast fallback
            self._routed_inflight = []
            self._packed = True
            self._packed_out = True
            self._vote_engine = None
            if self.use_native_vote and self.support_ranges == 1:
                from utree_tpu.native import VoteEngine

                eng = VoteEngine(self.index.strings, cfg.taxacut)
                if eng.available:
                    self._vote_engine = eng
            return
        if self._table is None:
            # below _HASH_AUTO_MAX auto mode tries the hash tables; their own
            # memory caps decide, falling back to the replay arrays
            use_hash = self.lookup_mode in ("hash", "canonical", "displaced") or (
                self.lookup_mode == "auto"
                and self.index.num_records < _HASH_AUTO_MAX
            )
            if cfg.packsize == 64:
                if self.lookup_mode not in ("auto", "canonical", "displaced"):
                    # don't silently ignore an explicit table-layout request
                    raise ValueError(
                        f"--lookup-mode {self.lookup_mode!r} is unsupported for "
                        "PACKSIZE=64; device paths are the canonical hash and "
                        "the seeded-displacement table"
                    )
                # 64-mer device paths: canonical-hash ladder below the
                # displaced crossover, seeded displacement above (the same
                # choice as k=32; 104-bit suffixes have no device bsearch)
                # — --host otherwise
                from utree_tpu.hash_index64 import (build_canonical_hash_index64,
                                                    build_displaced_index64)

                self._table = None
                if self.lookup_mode == "displaced" or (
                    self.lookup_mode == "auto"
                    and self.index.num_records >= _DISPLACED_AUTO_MIN
                ):
                    try:
                        self._table = build_displaced_index64(
                            self.index, t1_cap=self._t1_cap).device_put(self._repl)
                    except (ValueError, RuntimeError) as e:
                        if self.lookup_mode == "displaced":
                            raise RuntimeError(
                                f"--lookup-mode displaced cannot be honored: {e}"
                            ) from e
                if self._table is None:
                    try:
                        self._table = build_canonical_hash_index64(
                            self.index, t1_cap=self._t1_cap).device_put(self._repl)
                    except (ValueError, RuntimeError) as e:
                        raise RuntimeError(
                            "PACKSIZE=64 device search needs the canonical hash "
                            f"table, which this DB cannot build ({e}); use the "
                            "host path (search --host)"
                        ) from e
            elif (
                self.lookup_mode in ("auto", "canonical", "displaced")
                and use_hash
                and cfg.packsize == 32
            ):
                from utree_tpu.hash_index import (build_canonical_hash_index,
                                                  build_displaced_index)

                # auto ordering: below _DISPLACED_AUTO_MIN entries the 2-slot
                # ladder tier A (one row gather, no seed read) serves; above
                # it the seeded-displacement table (a seed read + one row
                # gather at any scale) replaces the 3-level chain (two row
                # gathers)
                self._table = None
                if self.lookup_mode == "displaced" or (
                    self.lookup_mode == "auto"
                    and self.index.num_records >= _DISPLACED_AUTO_MIN
                ):
                    try:
                        self._table = build_displaced_index(
                            self.index, t1_cap=self._t1_cap).device_put(self._repl)
                    except (ValueError, RuntimeError) as e:
                        if self.lookup_mode == "displaced":
                            raise RuntimeError(
                                f"--lookup-mode displaced cannot be honored: {e}"
                            ) from e
                if self._table is None:
                    try:
                        self._table = build_canonical_hash_index(
                            self.index, t1_cap=self._t1_cap).device_put(self._repl)
                    except (ValueError, RuntimeError) as e:
                        if self.lookup_mode == "canonical":
                            raise RuntimeError(
                                f"--lookup-mode canonical cannot be honored: {e}"
                            ) from e
                        # neither device table fits this DB on one device.
                        # Only small DBs (degenerate-spill corner cases) may
                        # quietly take the bsearch replay, which auto mode
                        # must not silently accept at L2+ density
                        if self.index.num_records >= _REPLAY_AUTO_MAX:
                            raise RuntimeError(
                                f"this DB ({self.index.num_records:,} records) fits "
                                f"no single-device table ({e}); shard it across "
                                "devices with --devices N --lookup-mode routed, or "
                                "force the slower replay explicitly with "
                                "--lookup-mode bsearch"
                            ) from e
                        self._table = self.index.device_put(self._repl)
            elif use_hash:
                if self.lookup_mode == "canonical":
                    raise RuntimeError(
                        "--lookup-mode canonical requires PACKSIZE=32"
                    )
                from utree_tpu.hash_index import build_hash_index

                self._table = build_hash_index(self.index).device_put(self._repl)
            else:
                # explicit --lookup-mode bsearch, or auto beyond the hash
                # tables' ceiling.  Auto must not silently serve a huge DB at
                # replay speed
                if (self.lookup_mode == "auto"
                        and self.index.num_records >= _REPLAY_AUTO_MAX):
                    raise RuntimeError(
                        f"this DB ({self.index.num_records:,} records) exceeds the "
                        "single-device table ceiling; shard it across devices "
                        "with --devices N --lookup-mode routed, or force the "
                        "slower replay explicitly with --lookup-mode bsearch")
                self._table = self.index.device_put(self._repl)
        self._vote_engine = None
        if self.use_native_vote and self.support_ranges == 1:
            from utree_tpu.native import VoteEngine

            eng = VoteEngine(self.index.strings, cfg.taxacut)
            if eng.available:
                self._vote_engine = eng
        common = dict(
            k=cfg.packsize,
            do_rc=self.do_rc,
            probe_iters=self.index.probe_iters,
            # IXTYPE=u32 makes cfg.bad_ix 2^32-1, which overflows the int32
            # device lanes; any miss sentinel >= num_labels is equivalent
            # (the histogram only tests ix < num_labels)
            bad_ix=min(cfg.bad_ix, 0x7FFFFFFF),
            num_labels=self.index.num_labels,
            cap=self.hist_cap,
        )
        # The table travels as a jit ARGUMENT (device-resident, free to
        # stage).  Never close over it: jit embeds captured arrays as MLIR
        # constants, which downloads the whole table to host at every
        # lowering — minutes per compile at GB scale.
        # Input 2-bit packing applies to every k=32 DB; the u16-PACKED output
        # additionally needs label ids < 65535 (IXTYPE=u32 DBs use the
        # unpacked int32 histogram layout instead).
        self._packed = cfg.packsize == 32
        self._packed_out = self._packed and self.index.num_labels < 0xFFFF
        # mesh mode: table replicated (pytree-prefix sharding), batch rows
        # sharded over `data`; XLA auto-partitions the gather/elementwise work
        shard_kw = {}
        if self._mesh is not None:
            shard_kw = dict(out_shardings=self._data)
        if self._packed or self._packed_out:
            from utree_tpu.lookup import (search_step_hist_compact,
                                          search_step_hist_packed,
                                          search_step_hist_packed_in,
                                          search_step_vote_compact)

            raw = search_step_hist_packed if self._packed_out else search_step_hist_packed_in
            base = functools.partial(raw, **common)
            devvote_tab = None
            if (self._packed_out and self.device_vote
                    and self.support_ranges == 1
                    and self._vote_engine is not None):
                from utree_tpu.classify_device import build_aufbau_tables

                tab = build_aufbau_tables(self.index.strings)
                if tab.max_len <= 2047:  # dv must fit its 11-bit lane
                    devvote_tab = tab
            if self._mesh is not None:
                hist_base = base
                if devvote_tab is not None:
                    # device vote composes with the replicated-table DP mesh:
                    # the walk is per-lane, vote tables replicate with the
                    # rest of the table pytree, rows shard over `data` — the
                    # host-side vote (the per-host wall at N devices/host)
                    # disappears in multi-device mode too
                    self._devvote = True
                    vt = devvote_tab.device_put(self._repl)
                    self._table = {**self._table,
                                   **{"vt_" + kk: v for kk, v in vt.items()}}
                    max_iters = ((devvote_tab.max_len + 4)
                                 * (self.hist_cap + 2) + 16)
                    base = functools.partial(search_step_vote_compact,
                                             taxacut=cfg.taxacut,
                                             max_iters=max_iters, **common)

                # pjit forbids kwargs with in_shardings: the jitted step
                # takes true_len as a static positional arg, and the step
                # the dispatcher calls adapts its keyword to it
                def _mesh_jit(fn):
                    def positional(table, packed, vbits, lens, true_len):
                        return fn(table, packed, vbits, lens,
                                  true_len=true_len)

                    return jax.jit(positional, static_argnums=(4,),
                                   in_shardings=(self._repl, self._data,
                                                 self._data, self._data),
                                   **shard_kw)

                def _keyword(inner):
                    def step(table, packed, vbits, lens, *, true_len):
                        return inner(table, packed, vbits, lens, true_len)

                    return step

                self._step_jit = _mesh_jit(base)
                self._step = _keyword(self._step_jit)
                if self._devvote:
                    # long-read chunks need per-chunk HISTOGRAMS (merged on
                    # host before one vote), so the histogram step is kept
                    self._step_hist = _keyword(_mesh_jit(hist_base))
            elif devvote_tab is not None:
                # aufbau ON DEVICE: the readback is 12B/read flat, no
                # per-read histogram rows; the host only formats lines
                # (utree_format_device_vote).  Flagged reads (nuniq >
                # hist_cap, or value-range overflow) take the host-replay
                # override CSR — the usual cap-overflow contract.
                self._devvote = True
                vt = devvote_tab.device_put()
                self._table = {**self._table,
                               **{"vt_" + kk: v for kk, v in vt.items()}}
                max_iters = ((devvote_tab.max_len + 4)
                             * (self.hist_cap + 2) + 16)
                self._step = jax.jit(
                    functools.partial(search_step_vote_compact,
                                      taxacut=cfg.taxacut,
                                      max_iters=max_iters, **common),
                    static_argnames=("true_len",))
                # long-read chunks need per-chunk histograms (merged on host
                # before ONE vote over the whole read); keep the full layout
                self._step_hist = jax.jit(base, static_argnames=("true_len",))
            elif self._packed_out and self.compact_readback:
                self._compact = True
                self._over_cap = (self.compact_over_cap
                                  or max(64, self.batch_size // 8))
                self._step = jax.jit(
                    functools.partial(search_step_hist_compact,
                                      over_cap=self._over_cap, **common),
                    static_argnames=("true_len",))
                self._step_full = jax.jit(base, static_argnames=("true_len",))
                # dispatch handle -> its host input arrays, so an overflowed
                # batch can be redispatched through the full layout.  Values
                # hold the handle itself: a live strong ref pins id(h)
                # uniqueness (Python recycles ids of collected objects)
                self._inflight: dict[int, tuple] = {}
            else:
                self._step = jax.jit(base, static_argnames=("true_len",))
        else:
            if self._mesh is not None:
                shard_kw["in_shardings"] = (self._repl, self._data, self._data)
            self._step = jax.jit(functools.partial(search_step_hist, **common),
                                 **shard_kw)

    @property
    def table_kind(self) -> str:
        """Which device table layout this pipeline resolved to:
        'displaced' (seeded), 'canonical' (ladder), 'canonical64', 'hash', 'bsearch'
        (probe-replay).  Benches report it so regimes are identifiable."""
        t = self._table
        if "d1" in t:
            return "displaced"
        if "c1" in t:
            return "canonical"
        if "c64_1" in t:
            return "canonical64"
        if "d64_1" in t:
            return "displaced64"
        if "ds" in t:
            return "routed-displaced"
        if "t1" in t:
            return "hash"
        return "bsearch"

    def describe(self) -> dict:
        """Which layout and engines this pipeline resolved to: the table
        kind, whether the vote runs on the device, whether the native C++
        vote engine and FASTA scanner are loaded (else the Python twins
        run), and how many devices it spans."""
        from utree_tpu.native import fasta_lib

        return {
            "table_kind": self.table_kind,
            "device_vote": self._devvote,
            "native_vote": self._vote_engine is not None,
            "native_scanner": fasta_lib() is not None,
            "devices": 1 if self._mesh is None else self._mesh.devices.size,
            "t1_cap": self._t1_cap,
        }

    def compiled_step(self, read_len: int):
        """The main packed-input step compiled for one full batch of
        `read_len`-base reads, for inspection (`.memory_analysis()`,
        `.as_text()`)."""
        import jax.numpy as jnp

        if not self._packed:
            raise ValueError("compiled_step covers the packed-input steps")
        k = self.index.config.packsize
        lmax = _bucket_len64(max(read_len, k))
        b = self.batch_size
        args = (jax.ShapeDtypeStruct((b, lmax // 4), jnp.uint8),
                jax.ShapeDtypeStruct((b, lmax // 8), jnp.uint8),
                jax.ShapeDtypeStruct((b,), jnp.int32))
        if self._routed:
            return self._step_routed.lower(self._table, *args).compile()
        tl = min(max(k, (read_len + 7) & ~7), lmax)
        if self._step_jit is not None:  # mesh: the jitted positional step
            return self._step_jit.lower(self._table, *args, tl).compile()
        return self._step.lower(self._table, *args, true_len=tl).compile()

    # ---- device dispatch -----------------------------------------------

    def _pack(self, seqs: list[bytes]):
        bsz = len(seqs)
        max_len = max((len(s) for s in seqs), default=1)
        lmax = _bucket_len64(max(max_len, self.index.config.packsize))
        reads = np.zeros((bsz, lmax), dtype=np.uint8)
        lengths = np.zeros(bsz, dtype=np.int32)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
            lengths[i] = len(s)
        return reads, lengths

    def dispatch(self, seqs: list[bytes]):
        """Asynchronously dispatch one batch; returns device handles."""
        reads, lengths = self._pack(seqs)
        return self.dispatch_matrix(reads, lengths)

    def _pad_rows(self, *arrays):
        """Pad the batch (row) dim to a multiple of the mesh size; padded rows
        have length 0 and classify to nothing."""
        if self._mesh is None:
            return arrays
        d = self._mesh.devices.size
        b = arrays[0].shape[0]
        pad = (-b) % d
        if pad == 0:
            return arrays
        return tuple(np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                     for a in arrays)

    def dispatch_matrix(self, reads: np.ndarray, lengths: np.ndarray):
        reads, lengths = self._pad_rows(reads, lengths)
        if self._packed:
            from utree_tpu.lookup import pack_reads_host

            if reads.shape[1] % 8:
                reads = np.pad(reads, ((0, 0), (0, 8 - reads.shape[1] % 8)))
            packed, vbits, lens = pack_reads_host(reads, lengths)
            return self.dispatch_packed(packed, vbits, lens)
        if self._mesh is not None:
            return self._step(self._table, reads, lengths.astype(np.int32))
        return self._step(self._table, jax.device_put(reads),
                          jax.device_put(lengths.astype(np.int32)))

    def dispatch_packed(self, packed: np.ndarray, vbits: np.ndarray, lens: np.ndarray):
        """Dispatch pre-2-bit-packed reads (e.g. from the C++ scanner).

        The window count is trimmed to the batch's true max read length
        (rounded to 8 to bound jit variants): the transfer buffer's padded
        width would otherwise cost ~26% extra windows on 150bp reads."""
        k = self.index.config.packsize
        tl = int(lens.max()) if len(lens) else k
        tl = min(max(k, (tl + 7) & ~7), packed.shape[1] * 4)
        packed, vbits, lens = self._pad_rows(packed, vbits, lens)
        if self._routed:
            h = self._step_routed(self._table, packed, vbits, lens)
            self._routed_inflight.append((packed, vbits, lens))
            return h
        if self._mesh is not None:
            # jit's in_shardings place the host arrays directly
            return self._step(self._table, packed, vbits, lens, true_len=tl)
        h = self._step(self._table, jax.device_put(packed),
                       jax.device_put(vbits), jax.device_put(lens),
                       true_len=tl)
        if self._compact:
            self._inflight[id(h)] = (h, packed, vbits, lens, tl)
            while len(self._inflight) > 16:  # never-drained dispatch hygiene
                self._inflight.pop(next(iter(self._inflight)))
        return h

    # ---- host-side exact fallback (overflowed histograms) ----------------

    def _host_hits(self, seq: bytes) -> np.ndarray:
        from utree_tpu.encode import search_window_words

        cfg = self.index.config
        words = search_window_words(seq, cfg.packsize, self.do_rc)
        if len(words) == 0:
            return np.zeros(0, np.int64)
        if self.index.s_hi64 is not None:  # PACKSIZE=64: exact host replay
            from utree_tpu.search_host import lookup_words

            if not hasattr(self, "_hidx"):
                self._hidx = self.index.host_index()
            ixs = lookup_words(self._hidx, words)
            return ixs[ixs < self.index.num_labels]
        idx = self.index
        suffixes = (idx.suf_hi[:-1].astype(np.uint64) << np.uint64(32)) | idx.suf_lo[:-1].astype(
            np.uint32
        ).astype(np.uint64)
        qpre = (words >> np.uint64(cfg.ctr_suffix_bits)).astype(np.int64)
        qsuf = words & np.uint64(cfg.suffix_mask)
        start = idx.bin_ix[qpre].astype(np.int64)
        end = idx.bin_ix[qpre + 1].astype(np.int64)
        empty = start >= end
        p = np.where(empty, 0, start)
        size = np.where(empty, 0, end - start - 1)
        while (size > 0).any():
            active = size > 0
            w = size >> 1
            probe = np.minimum(p + w + 1, len(suffixes) - 1)
            le = active & (suffixes[probe] <= qsuf)
            p = np.where(le, p + w + 1, p)
            size = np.where(active, np.where(le, size - w - 1, w), size)
        found = (~empty) & (suffixes[np.minimum(p, len(suffixes) - 1)] == qsuf)
        hits = idx.ix[:-1][p[found]]
        return hits[hits < self.index.num_labels]

    # ---- vote + format -----------------------------------------------------

    def _to_host(self, handles):
        """Pull one batch's histograms to host.  In routed mode this also
        consumes the in-flight FIFO entry and, when the step flagged a
        capacity overflow (last column, identical across rows), redispatches
        the batch through the exact broadcast fallback."""
        if self.tracer is not None:  # split drain into device-wait vs host vote
            with self.tracer.phase("drain:d2h-wait"):
                arr = np.asarray(handles)
        else:
            arr = np.asarray(handles)
        if self._routed:
            inputs = self._routed_inflight.pop(0)
            if arr.shape[0] and arr[0, -1]:
                arr = np.asarray(self._fallback_step(self._table, *inputs))
            else:
                arr = arr[:, :-1]
        elif self._compact and arr.ndim == 1:
            if self.tracer is not None:
                with self.tracer.phase("drain:unpack"):
                    arr = self._decompact(handles, arr)
            else:
                arr = self._decompact(handles, arr)
        return arr

    def _decompact(self, handles, arr: np.ndarray) -> np.ndarray:
        """Reconstruct the full (B, cap+1) packed histogram matrix from the
        compact readback vector (lookup.search_step_hist_compact).  When the
        overflow block was too small for this batch's >= 2-label reads, the
        batch is redispatched through the full layout (exact, just slower)."""
        cap = self.hist_cap
        oc = self._over_cap
        block = (oc + 1) * (cap + 1)
        b = (arr.size - block) // 2
        main = arr[: 2 * b].reshape(b, 2)
        over = arr[2 * b:].reshape(oc + 1, cap + 1)
        entry = self._inflight.pop(id(handles), None)
        n_over = int(over[0, 0])
        if n_over > oc:
            if entry is None:
                raise RuntimeError(
                    "compact readback overflowed its block but the dispatch "
                    "inputs were evicted; drain batches in dispatch order")
            _h, packed, vbits, lens, tl = entry
            return np.asarray(self._step_full(
                self._table, jax.device_put(packed), jax.device_put(vbits),
                jax.device_put(lens), true_len=tl))
        mat = np.zeros((b, cap + 1), np.int32)
        mat[:, cap] = main[:, 0]   # tail: nuniq | found<<5
        mat[:, 0] = main[:, 1]     # first histogram slot
        if n_over:
            rows = over[1 : 1 + n_over]
            mat[rows[:, 0], :cap] = rows[:, 1:]
        return mat

    def _unpack(self, handles):
        arr = self._to_host(handles)
        cap = self.hist_cap
        if self._packed_out:
            u = arr.view(np.uint32) if arr.dtype == np.int32 else arr.astype(np.uint32)
            lc = u[:, :cap]
            labels = (lc & 0xFFFF).astype(np.int32) - 1
            counts = (lc >> 16).astype(np.int32)
            tail = u[:, cap]
            nuniq = (tail & 31).astype(np.int32)
            found = (tail >> 5).astype(np.int32)
            return labels, counts, nuniq, found
        return arr[:, :cap], arr[:, cap : 2 * cap], arr[:, 2 * cap], arr[:, 2 * cap + 1]

    def _devvote_rows(self, handles, count) -> np.ndarray:
        """(count, 3) uint32 device-vote rows from the flat readback."""
        arr = self._to_host(handles)
        u = arr.view(np.uint32) if arr.dtype == np.int32 else arr.astype(np.uint32)
        return u.reshape(-1, 3)[:count]

    def _devvote_line(self, name: bytes, w0: int, w1: int, w2: int,
                      seq: bytes | None, seq_of=None, i: int = 0) -> bytes | None:
        """One read's line from its device-vote row (Python twin of
        utree_format_device_vote; the native formatter is the fast path)."""
        from utree_tpu.classify import aufbau_vote_counts
        from utree_tpu.classify_device import DV_EMPTY, DV_FULL

        nu = (w0 >> 17) & 31
        if nu == 0:
            return None
        strings = self.index.strings
        if (w0 >> 24) & 1:  # flagged: exact host replay
            s = seq if seq is not None else seq_of(i)
            hits = self._host_hits(s)
            cnt = np.bincount(hits)
            nz = np.flatnonzero(cnt)
            return aufbau_vote_counts(name, nz, cnt[nz], strings,
                                      self.index.config.taxacut, 1)
        rep = (w0 & 0x1FFFF) - 1
        found = w1 & 0xFFFFF
        if nu == 1:
            return (name + b"\t" + strings[rep] + b"\t"
                    + str(found).encode() + b"\t1\t*")
        dvcode = (w0 >> 22) & 3
        dv = (w1 >> 20) & 0x7FF
        sl, ol = w2 & 0xFFFF, w2 >> 16
        tp = (b"" if dvcode == DV_EMPTY
              else strings[rep] if dvcode == DV_FULL else strings[rep][:dv])
        return name + b"\t" + tp + b"\t%d\t%d\t%d;%d" % (found, nu, sl, ol)

    def _format_devvote(self, count, name_pool, name_offsets, handles,
                        seq_of) -> bytes:
        """Drain one device-voted batch: decode flags, host-replay the
        flagged reads into an override CSR, and format everything in C."""
        u = self._devvote_rows(handles, count)
        flags = np.flatnonzero((u[:, 0] >> 24) & 1).astype(np.int64)
        over_offsets = np.zeros(len(flags) + 1, np.int64)
        ols, ocs = [], []
        for j, i in enumerate(flags):
            hits = self._host_hits(seq_of(int(i)))
            cnt = np.bincount(hits)
            nz = np.flatnonzero(cnt)
            ols.append(nz.astype(np.int32))
            ocs.append(cnt[nz].astype(np.int32))
            over_offsets[j + 1] = over_offsets[j] + len(nz)
        over_labels = np.concatenate(ols) if ols else np.zeros(0, np.int32)
        over_counts = np.concatenate(ocs) if ocs else np.zeros(0, np.int32)
        if self.tracer is not None:
            with self.tracer.phase("drain:vote"):
                return self._vote_engine.format_device_vote(
                    count, name_pool, name_offsets, u, flags, over_offsets,
                    over_labels, over_counts)
        return self._vote_engine.format_device_vote(
            count, name_pool, name_offsets, u, flags, over_offsets,
            over_labels, over_counts)

    def finalize(self, names: list[bytes], seqs: list[bytes], handles) -> list[bytes | None]:
        if self._devvote:
            u = self._devvote_rows(handles, len(names))
            return [
                self._devvote_line(nm, int(u[i, 0]), int(u[i, 1]),
                                   int(u[i, 2]), seqs[i])
                for i, nm in enumerate(names)
            ]
        labels, counts, nuniq, found = self._unpack(handles)
        strings = self.index.strings
        taxacut = self.index.config.taxacut
        out: list[bytes | None] = []
        for i, name in enumerate(names):
            nu = int(nuniq[i])
            if nu == 0:
                out.append(None)
            elif nu <= self.hist_cap:
                out.append(
                    aufbau_vote_counts(name, labels[i, :nu], counts[i, :nu], strings,
                                       taxacut, self.support_ranges)
                )
            else:  # device cap overflow: recompute this read exactly on host
                hits = self._host_hits(seqs[i])
                cnt = np.bincount(hits)
                nz = np.flatnonzero(cnt)
                out.append(aufbau_vote_counts(name, nz, cnt[nz], strings, taxacut,
                                              self.support_ranges))
        return out

    def classify_batch(self, names: list[bytes], seqs: list[bytes]) -> list[bytes | None]:
        return self.finalize(names, seqs, self.dispatch(seqs))

    def finalize_bytes(self, names: list[bytes], seqs: list[bytes], handles) -> bytes:
        """Concatenated output lines (with trailing newlines), read order.
        Uses the C++ vote engine when available; overflowed histograms are
        recomputed exactly on host and spliced into the CSR first."""
        if self._vote_engine is None:
            return b"".join(
                ln + b"\n" for ln in self.finalize(names, seqs, handles) if ln is not None
            )
        if self._packed_out:
            n = len(names)
            name_offsets = np.zeros(n, np.int64)
            off = 0
            for i, nm in enumerate(names):
                name_offsets[i] = off
                off += len(nm) + 1
            name_pool = b"\x00".join(names) + b"\x00" if names else b"\x00"
            if self._devvote:
                return self._format_devvote(n, name_pool, name_offsets,
                                            handles, lambda i: seqs[i])
            return self._vote_packed(n, name_pool, name_offsets, handles,
                                     lambda i: seqs[i])
        labels, counts, nuniq, found = self._unpack(handles)
        b = len(names)
        nu = np.minimum(nuniq, self.hist_cap).astype(np.int64)
        overflow = np.flatnonzero(nuniq > self.hist_cap)
        extra_l: dict[int, np.ndarray] = {}
        extra_c: dict[int, np.ndarray] = {}
        for i in overflow:
            hits = self._host_hits(seqs[i])
            cnt = np.bincount(hits)
            nz = np.flatnonzero(cnt)
            extra_l[int(i)] = nz
            extra_c[int(i)] = cnt[nz]
            nu[i] = len(nz)
        offsets = np.zeros(b + 1, np.int64)
        np.cumsum(nu, out=offsets[1:])
        if len(overflow) == 0:
            # vectorized CSR flatten (row-major boolean mask preserves order)
            mask = np.arange(self.hist_cap)[None, :] < nu[:, None]
            flat_l = labels[mask].astype(np.int32)
            flat_c = counts[mask].astype(np.int32)
        else:
            flat_l = np.empty(int(offsets[-1]), np.int32)
            flat_c = np.empty(int(offsets[-1]), np.int32)
            for i in range(b):
                lo, hi = offsets[i], offsets[i + 1]
                if i in extra_l:
                    flat_l[lo:hi] = extra_l[i]
                    flat_c[lo:hi] = extra_c[i]
                else:
                    flat_l[lo:hi] = labels[i, : nu[i]]
                    flat_c[lo:hi] = counts[i, : nu[i]]
        return self._vote_engine.vote_batch(names, offsets, flat_l, flat_c)

    def _vote_packed(self, count, name_pool, name_offsets, handles, seq_of) -> bytes:
        """Drain one batch through utree_vote_packed: the raw packed device
        matrix goes straight to C++ (unpack + CSR flatten + vote + formatting
        in one OpenMP pass) instead of 4 full-matrix NumPy ops + a boolean-
        mask flatten.  Cap-overflow rows are recomputed exactly on host and
        passed as an override CSR (same contract as the NumPy path)."""
        arr = self._to_host(handles)
        u = arr.view(np.uint32) if arr.dtype == np.int32 else arr.astype(np.uint32)
        cap = self.hist_cap
        nuniq = u[:count, cap] & 31
        over = np.flatnonzero(nuniq > cap).astype(np.int64)
        over_offsets = np.zeros(len(over) + 1, np.int64)
        ols, ocs = [], []
        for j, i in enumerate(over):
            hits = self._host_hits(seq_of(int(i)))
            cnt = np.bincount(hits)
            nz = np.flatnonzero(cnt)
            ols.append(nz.astype(np.int32))
            ocs.append(cnt[nz].astype(np.int32))
            over_offsets[j + 1] = over_offsets[j] + len(nz)
        over_labels = np.concatenate(ols) if ols else np.zeros(0, np.int32)
        over_counts = np.concatenate(ocs) if ocs else np.zeros(0, np.int32)
        if self.tracer is not None:
            with self.tracer.phase("drain:vote"):
                return self._vote_engine.vote_packed(
                    count, name_pool, name_offsets, u[:count], cap,
                    over, over_offsets, over_labels, over_counts)
        return self._vote_engine.vote_packed(
            count, name_pool, name_offsets, u[:count], cap,
            over, over_offsets, over_labels, over_counts)

    # ---- long reads (up to 16Mb, itree.c:836) --------------------------------
    # threshold keeps short-path window counts < 2^16 (u16 output packing)

    long_read_threshold: int = 1 << 14
    long_chunk: int = 1 << 14

    def _dispatch_hist(self, reads: np.ndarray, lengths: np.ndarray):
        """Dispatch through the HISTOGRAM-layout step.  In device-vote mode
        the main step votes per row, which is wrong for long-read chunks
        (their histograms must merge on host before one vote over the whole
        read), so those go through the retained full-layout step."""
        if not self._devvote:
            return self.dispatch_matrix(reads, lengths)
        from utree_tpu.lookup import pack_reads_host

        reads, lengths = self._pad_rows(reads, lengths)
        if reads.shape[1] % 8:
            reads = np.pad(reads, ((0, 0), (0, 8 - reads.shape[1] % 8)))
        packed, vbits, lens = pack_reads_host(reads, lengths.astype(np.int32))
        k = self.index.config.packsize
        tl = int(lens.max()) if len(lens) else k
        tl = min(max(k, (tl + 7) & ~7), packed.shape[1] * 4)
        if self._mesh is not None:
            return self._step_hist(self._table, packed, vbits, lens,
                                   true_len=tl)
        return self._step_hist(self._table, jax.device_put(packed),
                               jax.device_put(vbits), jax.device_put(lens),
                               true_len=tl)

    def classify_long_read(self, name: bytes, seq: bytes) -> bytes | None:
        """Position-sharded long-read classification: the read's windows are
        split into chunk rows (each chunk scans forward+RC of its own span,
        which yields exactly the full read's hit multiset — see
        parallel.long_read_histogram), histograms merge on host, then the
        ordinary vote runs.  Exact at any chunk size."""
        from utree_tpu.parallel.sharded import split_long_read

        k = self.index.config.packsize
        num_chunks = max(1, -(-max(0, len(seq) - k + 1) // self.long_chunk))
        num_chunks = _bucket_len(num_chunks, minimum=1)  # bound jit recompiles
        chunks, lens = split_long_read(seq, num_chunks, k)
        labels, counts, nuniq, _found = self._unpack(self._dispatch_hist(chunks, lens))
        cap = self.hist_cap
        agg: dict[int, int] = {}
        for r in range(len(chunks)):
            if nuniq[r] > cap:  # chunk overflowed the device histogram
                hits = self._host_hits(chunks[r, : lens[r]].tobytes())
                for h in hits:
                    agg[int(h)] = agg.get(int(h), 0) + 1
            else:
                for s in range(int(nuniq[r])):
                    agg[int(labels[r, s])] = agg.get(int(labels[r, s]), 0) + int(counts[r, s])
        if not agg:
            return None
        ks = np.array(sorted(agg), np.int64)
        vs = np.array([agg[int(x)] for x in ks], np.int64)
        return aufbau_vote_counts(name, ks, vs, self.index.strings,
                                  self.index.config.taxacut, self.support_ranges)

    # ---- streaming driver ----------------------------------------------------

    def search_file(self, reads_path: str, out_path: str, queue_depth: int = 3,
                    resume: bool = False,
                    record_range: tuple[int, int] | None = None) -> int:
        """Stream reads -> classifications.  With resume=True, continues an
        interrupted run from the last committed batch boundary (sidecar
        <out>.ckpt); the final output bytes equal an uninterrupted run.
        record_range=(lo, hi) processes only that slice of the file's records
        (the multi-host partition; parallel.distributed.host_read_range).
        Files take the C++-scanner streaming path when the native runtime is
        available; .gz inputs stream through zlib into the same piece
        iterator (the reference's gzread chunking, xtree.c:180-204)."""
        if self._vote_engine is not None:
            from utree_tpu.native import fasta_lib

            if fasta_lib() is not None:
                return self._search_file_native(reads_path, out_path, queue_depth,
                                                resume, record_range)
        return self._search_file_py(reads_path, out_path, queue_depth, resume,
                                    record_range)

    # streamed ingestion: pieces of ~this many bytes are scanned and packed
    # between dispatches — search RSS is O(chunk), not O(file) (the reference
    # streams with fgets/gz chunks, itree.c:867-875; xtree.c:180-204) —
    # ~2 batches of 150bp reads per piece, so only the FIRST piece's scan
    # runs before the device has work (host CPU: 0.44s for a 240MB single
    # piece vs ~10ms at 32MB); later pieces scan while the device drains
    # the 3-deep queue
    stream_chunk_bytes: int = 32 << 20

    def _iter_fasta_pieces(self, reads_path: str, tm):
        """Yield FastaScanner pieces covering the file in order.  Pieces are
        cut at record boundaries ('\\n>'), so every record lives in exactly
        one piece; a record larger than the chunk grows the tail until its
        end arrives (max query is 16Mb, itree.c:836)."""
        from utree_tpu.native import FastaScanner

        chunk_bytes = max(1 << 16, self.stream_chunk_bytes)
        if str(reads_path).endswith(".gz"):
            import gzip

            opener = gzip.open
        else:
            opener = open
        with opener(reads_path, "rb") as f:
            tail = b""
            while True:
                with tm.phase("scan"):
                    chunk = f.read(chunk_bytes)
                if not chunk:
                    if tail:
                        with tm.phase("scan"):
                            sc = FastaScanner(tail)
                        yield sc  # outside the phase: the consumer's work is not scan time
                    return
                data = tail + chunk
                if len(chunk) == chunk_bytes:  # likely more data follows
                    cut = data.rfind(b"\n>")
                    if cut == -1:
                        tail = data  # one record spans the chunk: keep growing
                        continue
                    piece, tail = data[: cut + 1], data[cut + 1 :]
                else:
                    piece, tail = data, b""
                if piece:
                    with tm.phase("scan"):
                        sc = FastaScanner(piece)
                    yield sc

    def _search_file_native(self, reads_path: str, out_path: str,
                            queue_depth: int, resume: bool,
                            record_range: tuple[int, int] | None = None) -> int:
        """C++-scanned streaming driver: file pieces are scanned and batches
        packed in C++, dispatch is asynchronous, and finished batches start
        their device->host copy early (copy_to_host_async) so the drain never
        blocks on the transfer.  Output identical to the Python driver.
        Scan/pack run inline on the calling thread; the overlap with device
        work comes from the async dispatch and async readback."""
        from utree_tpu.utils.checkpoint import SearchCheckpoint
        from utree_tpu.utils.trace import PhaseTimer

        tm = self.tracer if self.tracer is not None else PhaseTimer(quiet=True)
        ckpt = SearchCheckpoint(out_path)
        skip, out_bytes = ckpt.load() if resume else (0, 0)
        range_lo, range_hi = record_range if record_range is not None else (0, None)
        skip += range_lo  # ckpt's `done` counts records from the range start
        mode = "r+b" if resume and pathlib.Path(out_path).exists() else "wb"
        pending: list[tuple] = []
        threshold = self.long_read_threshold
        packsize = self.index.config.packsize

        def batches():
            # batches ACCUMULATE across piece boundaries: a partial batch is
            # never dispatched mid-stream (padding it to batch_size would
            # cost a full device batch), only at long-read/EOF flushes
            r_global = 0
            spans: list[tuple] = []  # (scanner, start, count) of this batch
            acc = 0
            maxlen = 0

            def flush():
                nonlocal spans, acc, maxlen
                if not acc:
                    return None
                lmax = max(_bucket_len64(maxlen), packsize)
                with tm.phase("pack"):
                    pools = []
                    offs = []
                    row = 0
                    shift = 0
                    if self._packed:  # 2-bit packing in C++ (memcpy speed)
                        packed = np.zeros((self.batch_size, lmax // 4), np.uint8)
                        vbits = np.zeros((self.batch_size, lmax // 8), np.uint8)
                        lens = np.zeros(self.batch_size, np.int32)
                        for sc, start, count in spans:
                            p2, v2, l2, npool, noffs = sc.pack_2bit(start, count, lmax)
                            packed[row:row + count] = p2
                            vbits[row:row + count] = v2
                            lens[row:row + count] = l2[:count]
                            pools.append(npool)
                            offs.append(noffs[:-1] + shift)
                            shift += len(npool)
                            row += count
                        arrays = (packed, vbits, lens)
                    else:
                        reads = np.zeros((self.batch_size, lmax), np.uint8)
                        lens = np.zeros(self.batch_size, np.int32)
                        for sc, start, count in spans:
                            rd, l2, npool, noffs = sc.pack(start, count, lmax)
                            reads[row:row + count] = rd
                            lens[row:row + count] = l2[:count]
                            pools.append(npool)
                            offs.append(noffs[:-1] + shift)
                            shift += len(npool)
                            row += count
                        arrays = (reads, lens)
                    item = ("batch", spans, acc, arrays, b"".join(pools),
                            np.concatenate(offs))
                spans, acc, maxlen = [], 0, 0
                return item

            for sc in self._iter_fasta_pieces(reads_path, tm):
                if range_hi is not None and r_global >= range_hi:
                    break
                n_piece = sc.num_records
                lens_all = sc.seq_lengths()
                r = 0
                while r < n_piece:
                    if range_hi is not None and r_global >= range_hi:
                        break
                    if r_global < skip:  # resume / range: skip records
                        adv = int(min(n_piece - r, skip - r_global))
                        r += adv
                        r_global += adv
                        continue
                    if lens_all[r] > threshold:
                        b = flush()  # long reads emit in record order
                        if b is not None:
                            yield b
                        yield ("long", sc.record_name(r), sc.record_seq(r))
                        r += 1
                        r_global += 1
                        continue
                    e = r
                    lim = self.batch_size - acc
                    while (e < n_piece and e - r < lim
                           and lens_all[e] <= threshold):
                        if range_hi is not None and r_global + (e - r) >= range_hi:
                            break
                        e += 1
                    count = e - r
                    if count:
                        spans.append((sc, r, count))
                        acc += count
                        maxlen = max(maxlen, int(lens_all[r:e].max()))
                        r = e
                        r_global += count
                    if acc >= self.batch_size:
                        yield flush()
            b = flush()
            if b is not None:
                yield b
            yield ("eof", min(r_global, range_hi) if range_hi is not None else r_global)

        with open(out_path, mode) as fo:
            fo.truncate(out_bytes)
            fo.seek(out_bytes)
            done = skip

            def row_seq(spans, i):
                for sc, start, count in spans:
                    if i < count:
                        return sc.record_seq(start + i)
                    i -= count
                raise IndexError(i)

            def finalize_native(spans, count, h, name_pool, name_offsets):
                if self._devvote:
                    return self._format_devvote(count, name_pool, name_offsets,
                                                h, lambda i: row_seq(spans, i))
                if self._packed_out:
                    return self._vote_packed(count, name_pool, name_offsets, h,
                                             lambda i: row_seq(spans, i))
                labels, counts, nuniq, found = self._unpack(h)
                labels, counts, nuniq = labels[:count], counts[:count], nuniq[:count]
                nu = np.minimum(nuniq, self.hist_cap).astype(np.int64)
                over = np.flatnonzero(nuniq > self.hist_cap)
                offsets = np.zeros(count + 1, np.int64)
                if len(over) == 0:
                    np.cumsum(nu, out=offsets[1:])
                    mask = np.arange(self.hist_cap)[None, :] < nu[:, None]
                    flat_l = labels[mask].astype(np.int32)
                    flat_c = counts[mask].astype(np.int32)
                else:
                    extra = {}
                    for i in over:
                        hits = self._host_hits(row_seq(spans, int(i)))
                        cnt = np.bincount(hits)
                        nz = np.flatnonzero(cnt)
                        extra[int(i)] = (nz, cnt[nz])
                        nu[i] = len(nz)
                    np.cumsum(nu, out=offsets[1:])
                    flat_l = np.empty(int(offsets[-1]), np.int32)
                    flat_c = np.empty(int(offsets[-1]), np.int32)
                    for i in range(count):
                        a, b = offsets[i], offsets[i + 1]
                        if i in extra:
                            flat_l[a:b], flat_c[a:b] = extra[i]
                        else:
                            flat_l[a:b] = labels[i, : nu[i]]
                            flat_c[a:b] = counts[i, : nu[i]]
                return self._vote_engine.vote_batch_pooled(
                    count, name_pool, name_offsets, offsets, flat_l, flat_c
                )

            def drain(block: bool):
                nonlocal done
                while pending and (block or len(pending) >= queue_depth):
                    spans, count, h, npool, noffs = pending.pop(0)
                    with tm.phase("drain+vote"):
                        lines = finalize_native(spans, count, h, npool, noffs)
                    with tm.phase("write"):
                        fo.write(lines)
                        fo.flush()
                        done += count
                        ckpt.commit(done - range_lo, fo.tell())

            n = skip
            for item in batches():
                kind = item[0]
                if kind == "eof":
                    n = item[1]
                    break
                if kind == "long":
                    drain(block=True)  # keep output in read order
                    with tm.phase("long-reads"):
                        line = self.classify_long_read(item[1], item[2])
                        if line is not None:
                            fo.write(line + b"\n")
                        fo.flush()
                    done += 1
                    ckpt.commit(done - range_lo, fo.tell())
                    continue
                _, spans, count, arrays, npool, noffs = item
                with tm.phase("dispatch"):
                    if self._packed:
                        handle = self.dispatch_packed(*arrays)
                    else:
                        handle = self.dispatch_matrix(*arrays)
                    try:  # start the D->H copy as soon as compute finishes
                        handle.copy_to_host_async()
                    except (AttributeError, NotImplementedError):
                        pass
                pending.append((spans, count, handle, npool, noffs))
                drain(block=False)
            drain(block=True)
        ckpt.finish()
        tm.count("reads", n - skip)
        return n - range_lo

    def _search_file_py(self, reads_path: str, out_path: str, queue_depth: int,
                        resume: bool,
                        record_range: tuple[int, int] | None = None) -> int:
        from utree_tpu.utils.checkpoint import SearchCheckpoint
        from utree_tpu.utils.trace import PhaseTimer

        tm = self.tracer if self.tracer is not None else PhaseTimer(quiet=True)
        ckpt = SearchCheckpoint(out_path)
        skip, out_bytes = ckpt.load() if resume else (0, 0)
        lo, hi = record_range if record_range is not None else (0, None)
        skip += lo  # ckpt's `done` counts records from the range start
        n = 0
        pending: list[tuple[list[bytes], list[bytes], object]] = []
        names: list[bytes] = []
        seqs: list[bytes] = []
        mode = "r+b" if resume and pathlib.Path(out_path).exists() else "wb"
        with open(out_path, mode) as fo:
            fo.truncate(out_bytes)
            fo.seek(out_bytes)
            done = skip

            def drain(block: bool):
                nonlocal done
                while pending and (block or len(pending) >= queue_depth):
                    bn, bs, h = pending.pop(0)
                    with tm.phase("drain+vote"):
                        lines = self.finalize_bytes(bn, bs, h)
                    with tm.phase("write"):
                        fo.write(lines)
                        fo.flush()
                        done += len(bn)
                        ckpt.commit(done - lo, fo.tell())

            for header, seq in iter_fasta_records(reads_path):
                if hi is not None and n >= hi:
                    break
                n += 1
                if n <= skip:
                    continue
                name = header.split(b" ")[0]
                if len(seq) > self.long_read_threshold:
                    # flush queued short reads first to keep output order
                    if seqs:
                        pending.append((names, seqs, self.dispatch(seqs)))
                        names, seqs = [], []
                    drain(block=True)
                    line = self.classify_long_read(name, seq)
                    if line is not None:
                        fo.write(line + b"\n")
                    fo.flush()
                    done += 1
                    ckpt.commit(done - lo, fo.tell())
                    continue
                names.append(name)
                seqs.append(seq)
                if len(seqs) >= self.batch_size:
                    with tm.phase("dispatch"):
                        pending.append((names, seqs, self.dispatch(seqs)))
                    names, seqs = [], []
                    drain(block=False)
            if seqs:
                with tm.phase("dispatch"):
                    pending.append((names, seqs, self.dispatch(seqs)))
            drain(block=True)
        ckpt.finish()
        tm.count("reads", max(0, n - skip))
        return n - lo
