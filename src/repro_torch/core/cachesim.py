"""Memory-hierarchy traffic model: L2 -> (optional memory-side L3) -> DRAM.

Faithful to the paper's §III-C microarchitecture:

* the L2 (inside the GPM) is the point of coherence and the first bandwidth
  filter; every post-L2 miss/writeback crosses the UHB link when an MSM with
  L3 is present;
* the L3 is a *memory-side* cache: it only observes post-L2 traffic, is
  neither inclusive nor exclusive, and needs no coherence. We model the
  (L2, L3) pair for DRAM-traffic purposes as a single LRU pool of capacity
  ``C_L2 + C_L3`` observed by DRAM — exact for the steady-state streaming
  traffic that dominates DL iterations (validated against BlockLRU in tests).

Residency is fractional at tensor granularity: a touch of tensor T with
bytes-weighted unique-reuse distance U against a cache of capacity C finds
``clip(C - U, 0, |T|)`` of its bytes resident. Writebacks use a per-tensor
dirty fraction; dirty bytes evicted before the next touch are charged to the
next level (attributed, for per-op accounting, to the touching op — the
evicting op is not identifiable at this granularity).

Steady state: the paper simulates one end-to-end iteration of workloads that
run for thousands of iterations, so cold misses are amortized; we double the
trace and read statistics off the second copy (``cyclic=True``).

Suite batching: :class:`StreamBatch` pads many traces' touch streams into
``(n_traces, max_len)`` tensors and runs the same scans over the batch axis
(bit-identical per row to the per-trace kernels), which is what lets
``repro_torch.core.sweep.SuiteAnalysis`` evaluate a whole scenario registry in a
single trace x config x capacity pass; :func:`build_streams` builds many
streams with one batched Mattson call, and streams are memoized
process-wide.

The JAX reference package's module, with the two batched scans on a device.
:func:`build_streams` takes a ``device`` (``None`` is the card, and raises
without one): on the CPU it runs the NumPy passes, and on the card every
stream's Mattson pass goes through
:func:`~repro_torch.core.stackdist._mattson_pass_batch_torch`, a stream
longer than ``_BATCH_MATTSON_MAX_LEN`` as a block of its own. A
:class:`StreamBatch` padded with a torch ``device`` uploads each block's
capacity-independent arrays once and runs :meth:`StreamBatch.traffic_matrices`
as torch operations there (:func:`_block_traffic_torch`), copying the two
matrices back once a call; without one it runs the NumPy scan
(:meth:`StreamBatch._block_traffic`, the plain version). The stream memo is
keyed by where the distances were computed, so a card's streams and the
host's are never mixed.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hw import GpuSpec
from repro_torch.core.stackdist import (
    PAD_ID,
    _mattson_pass,
    _mattson_pass_batch,
    _mattson_pass_batch_torch,
)
from repro_torch.core.trace import Trace


def scan_device(device=None) -> torch.device | None:
    """Where the batched scans for ``device`` run: ``None`` (NumPy on the
    host) for the CPU, else the card. ``device=None`` asks for the card and
    raises where there is none."""
    device = resolve_device(device)
    return None if device.type == "cpu" else device


def _backend_key(scan: torch.device | None) -> str:
    """The memo key of a scan device: ``"numpy"`` for the host passes."""
    return "numpy" if scan is None else str(scan)


@dataclass
class TouchStream:
    """Flattened, doubled touch arrays for one trace (capacity-independent)."""

    n_ops: int
    op_idx: np.ndarray     # int32, len 2T (doubled)
    sizes: np.ndarray      # float64
    is_write: np.ndarray   # bool
    dist: np.ndarray       # bytes-weighted unique reuse distance per touch
    tensor_idx: np.ndarray  # int64 dense tensor ids
    n_tensors: int
    second_half: int       # index where the steady-state copy begins
    # lazily-built tensor-sorted scan layout (see _stream_layout); cached on
    # the stream so re-padding a suite never recomputes the sort/segment pass
    _layout: "_StreamLayout | None" = field(default=None, repr=False,
                                            compare=False)

    @property
    def nbytes(self) -> int:
        """Approximate pinned bytes (stream cache accounting)."""
        total = (self.op_idx.nbytes + self.sizes.nbytes + self.is_write.nbytes
                 + self.dist.nbytes + self.tensor_idx.nbytes)
        if self._layout is not None:
            total += self._layout.nbytes
        return total


@dataclass
class _StreamLayout:
    """One stream's touches in tensor-sorted order with every
    capacity-independent quantity of the :func:`traffic_below` scan
    precomputed per stream: the sorted columns, the segment structure
    (first read after the last write, has-a-write-base) reduced to the
    recorded touches, and the local scatter indices. Computed once per
    stream (cached on the :class:`TouchStream`), so building or appending
    to a :class:`StreamBatch` is pure row assembly — no per-pad argsort or
    segment scans."""

    n: int                          # touch count (= row width before pads)
    sizes: np.ndarray               # (n,) float64, tensor-sorted
    dist: np.ndarray                # (n,) float64
    is_write: np.ndarray            # (n,) bool
    is_inf: np.ndarray              # (n,) bool: +inf distance
    rec_cols: np.ndarray            # (n_rec,) sorted-position column
    seg_rec: np.ndarray             # (n_rec,) first read after the last write
    has_base_rec: np.ndarray        # (n_rec,) last write inside own chain
    iw_rec: np.ndarray              # (n_rec,) is-write flag
    sizes_rec: np.ndarray           # (n_rec,) touch bytes
    op_rec: np.ndarray              # (n_rec,) LOCAL op id (pre-offset)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (
            self.sizes, self.dist, self.is_write, self.is_inf, self.rec_cols,
            self.seg_rec, self.has_base_rec, self.iw_rec, self.sizes_rec,
            self.op_rec))


def _stream_layout(stream: TouchStream) -> _StreamLayout:
    """The per-stream half of the old block build: sort by tensor id
    (stable, preserving time order inside each chain), derive the segment
    structure, and keep only the recorded-touch reductions. Identical math
    to the former in-block 2-D pass, evaluated per row — the values feeding
    :meth:`StreamBatch._block_traffic` are bit-identical either way."""
    lay = stream._layout
    if lay is not None:
        return lay
    n = len(stream.op_idx)
    order = np.argsort(stream.tensor_idx, kind="stable")
    sizes = stream.sizes[order]
    dist = stream.dist[order]
    is_write = stream.is_write[order]
    tid = stream.tensor_idx[order]
    pos = np.arange(n, dtype=np.int64)
    is_new = np.concatenate([[True], tid[1:] != tid[:-1]]) if n \
        else np.zeros(0, dtype=bool)
    chain_start = np.maximum.accumulate(np.where(is_new, pos, 0))
    last_write_incl = np.maximum.accumulate(np.where(is_write, pos, -1))
    last_write = np.concatenate([[-1], last_write_incl[:-1]]) if n \
        else np.zeros(0, dtype=np.int64)
    rec = np.nonzero(order >= stream.second_half)[0]
    lay = _StreamLayout(
        n=n,
        sizes=sizes,
        dist=dist,
        is_write=is_write,
        is_inf=np.isinf(dist),
        rec_cols=rec,
        seg_rec=(last_write + 1)[rec],
        has_base_rec=(last_write >= chain_start)[rec],
        iw_rec=is_write[rec],
        sizes_rec=sizes[rec],
        op_rec=stream.op_idx[order][rec].astype(np.int64),
    )
    stream._layout = lay
    return lay


#: Buffers are recycled REUSE_DELAY touches after death: asynchronous
#: execution keeps freed buffers pinned briefly, so reuse is near- but not
#: perfectly-immediate (calibrated against Fig 4's inference saturation
#: capacities).
REUSE_DELAY = 24


def _assign_buffers(trace: Trace) -> dict[str, str]:
    """Caching-allocator model: transient tensors (first touched by a write,
    later dead) recycle buffers freed by earlier-dying tensors, exactly like
    the framework allocators under the paper's traces. Returns a tensor->
    buffer mapping; persistent tensors (weights, optimizer state — read
    before written) and streaming inputs keep their own identity.

    Without this, every dirty activation would be charged a DRAM writeback
    once per iteration when its (never-reused) address range is evicted;
    with buffer recycling the next owner overwrites the dirty lines while
    they are still resident — which is what lets a large L3 collapse
    inference traffic (paper Fig 4's 16x)."""
    touches = list(trace.touches())
    first: dict[str, int] = {}
    last: dict[str, int] = {}
    size: dict[str, int] = {}
    first_is_write: dict[str, bool] = {}
    for pos, (_, t, b, w) in enumerate(touches):
        if t not in first:
            first[t] = pos
            first_is_write[t] = w
        last[t] = pos
        size[t] = max(size.get(t, 0), b)

    def transient(t: str) -> bool:
        return first_is_write[t] and not t.startswith("in.")

    # Free events sorted by position; greedy best-fit (smallest buffer >= size).
    mapping: dict[str, str] = {}
    free: list[tuple[int, str]] = []  # (buffer_size, buffer_name)
    deaths = sorted((last[t] + REUSE_DELAY, t) for t in first if transient(t))
    di = 0
    buf_of: dict[str, str] = {}
    import bisect

    for pos, (_, t, b, w) in enumerate(touches):
        while di < len(deaths) and deaths[di][0] < pos:
            dead = deaths[di][1]
            if dead in buf_of:
                bisect.insort(free, (size[dead], buf_of[dead]))
            di += 1
        if t in mapping or not transient(t) or first[t] != pos:
            continue
        i = bisect.bisect_left(free, (size[t], ""))
        if i < len(free):
            _, buf = free.pop(i)
        else:
            buf = f"__buf{len(buf_of)}.{t}"
        mapping[t] = buf
        buf_of[t] = buf
    return mapping


def _reference_flatten(trace: Trace, cyclic: bool, reuse_buffers: bool):
    """Per-touch oracle for :func:`_flatten_trace` (the original dict-based
    interning loop). Retained for parity tests and as the fallback for
    pathological tensor names that could alias a recycled-buffer name."""
    mapping = _assign_buffers(trace) if reuse_buffers else {}
    op_idx, tids, sizes, is_write = [], [], [], []
    intern: dict[str, int] = {}
    stream_seq = 0
    for i, t, b, w in trace.touches():
        op_idx.append(i)
        t = mapping.get(t, t)
        if t.startswith("in.") and t not in intern:
            # unique id now; forget it so the doubled copy gets a fresh one
            tids.append(len(intern) + 1_000_000_000 + stream_seq)
            stream_seq += 1
        else:
            tids.append(intern.setdefault(t, len(intern)))
        sizes.append(float(b))
        is_write.append(w)
    op_idx = np.asarray(op_idx, dtype=np.int32)
    tids = np.asarray(tids, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.float64)
    is_write = np.asarray(is_write, dtype=bool)
    n = len(op_idx)
    if cyclic and n:
        op_idx = np.concatenate([op_idx, op_idx])
        # Streaming tensors (ids >= 1e9) must NOT alias across the two copies.
        tids2 = np.where(tids >= 1_000_000_000, tids + 1_000_000_000, tids)
        tids = np.concatenate([tids, tids2])
        sizes = np.concatenate([sizes, sizes])
        is_write = np.concatenate([is_write, is_write])
    # Dense tensor ids (streaming copies included) for state arrays.
    if n:
        _, dense = np.unique(tids, return_inverse=True)
    else:
        dense = tids
    n_tensors = int(dense.max()) + 1 if n else 0
    return op_idx, dense, sizes, is_write, n_tensors, (n if cyclic else 0)


def _assign_buffer_ids(table) -> tuple[np.ndarray, int]:
    """Array-based twin of :func:`_assign_buffers`: the same greedy best-fit
    recycling, but iterating only over transient-tensor *births* (a handful
    per trace) instead of every touch. Free events accumulated between two
    births are drained at the later birth — the free list any allocation
    sees is identical, so the resulting tensor->buffer partition is
    bit-identical to the per-touch oracle (asserted in tests).

    Returns ``(map_id, n_fresh)``: ``map_id[k]`` is name id ``k``'s mapped
    id (itself for persistent/streaming tensors, ``K + j`` for the ``j``-th
    fresh buffer); ties in the free list and death order are broken on the
    exact buffer/tensor name strings the oracle uses."""
    import bisect

    K = table.n_names
    map_id = np.arange(K, dtype=np.int64)
    transient = table.first_is_write & ~table.stream_flag
    t_ids = np.nonzero(transient)[0]
    if not len(t_ids):
        return map_id, 0
    names = table.names
    births = t_ids[np.argsort(table.first[t_ids])]
    deaths = sorted((int(table.last[t]) + REUSE_DELAY, names[t], int(t))
                    for t in t_ids)
    free: list[tuple[float, str, int]] = []  # (size, buf_name, buf_id)
    allocated: dict[int, tuple[str, int]] = {}  # name id -> (buf_name, id)
    di = 0
    n_fresh = 0
    for t in births:
        birth = int(table.first[t])
        while di < len(deaths) and deaths[di][0] < birth:
            dead = deaths[di][2]
            if dead in allocated:
                bname, bid = allocated[dead]
                bisect.insort(free, (float(table.max_size[dead]), bname, bid))
            di += 1
        i = bisect.bisect_left(free, (float(table.max_size[t]), ""))
        if i < len(free):
            _, bname, bid = free.pop(i)
        else:
            # the oracle's fresh-name counter is "transients allocated so
            # far" (reusers included), so names match it exactly
            bname = f"__buf{len(allocated)}.{names[int(t)]}"
            bid = K + n_fresh
            n_fresh += 1
        allocated[int(t)] = (bname, bid)
        map_id[t] = bid
    return map_id, n_fresh


def _flatten_trace(trace: Trace, cyclic: bool, reuse_buffers: bool):
    """The capacity- and distance-independent part of :func:`build_stream`:
    flatten, buffer-recycle, double, and densify one trace's touches.
    Returns ``(op_idx, dense_tensor_ids, sizes, is_write, n_tensors,
    second_half)`` — everything a :class:`TouchStream` needs except the
    reuse distances.

    Array-based: raw touch columns come from the cached
    :meth:`~repro_torch.core.trace.Trace.touch_table`, recycling from
    :func:`_assign_buffer_ids`, and the dense ids in closed form — a
    non-streaming tensor's dense id is its first-appearance rank among
    non-streaming (mapped) names, the ``j``-th streaming touch gets
    ``K + j`` (second copy ``K + S + j``): exactly the order
    ``np.unique`` gave the oracle's sentinel ids. Bit-identical to
    :func:`_reference_flatten` (asserted in tests)."""
    table = trace.touch_table()
    n = table.n_touches
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return (np.zeros(0, dtype=np.int32), z, np.zeros(0),
                np.zeros(0, dtype=bool), 0, 0)
    if reuse_buffers:
        if table.has_buf_names:
            # a real tensor could alias a recycled-buffer name; take the
            # string-keyed oracle for this (pathological) trace
            return _reference_flatten(trace, cyclic, reuse_buffers)
        map_id, n_fresh = _assign_buffer_ids(table)
    else:
        map_id, n_fresh = np.arange(table.n_names, dtype=np.int64), 0
    mids = map_id[table.name_id]
    stream_ext = np.concatenate(
        [table.stream_flag, np.zeros(n_fresh, dtype=bool)])
    st = stream_ext[mids]
    S = int(np.count_nonzero(st))
    dense = np.empty(n, dtype=np.int64)
    ns = mids[~st]
    if len(ns):
        uniq, first_idx, inv = np.unique(ns, return_index=True,
                                         return_inverse=True)
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[np.argsort(first_idx)] = np.arange(len(uniq), dtype=np.int64)
        dense[~st] = rank[inv]
        k_ns = len(uniq)
    else:
        k_ns = 0
    dense[st] = k_ns + np.arange(S, dtype=np.int64)
    op_idx, sizes, is_write = table.op_idx, table.sizes, table.is_write
    if cyclic:
        op_idx = np.concatenate([op_idx, op_idx])
        # streaming tensors must NOT alias across the two copies
        dense = np.concatenate([dense, np.where(st, dense + S, dense)])
        sizes = np.concatenate([sizes, sizes])
        is_write = np.concatenate([is_write, is_write])
        n_tensors = k_ns + 2 * S
    else:
        n_tensors = k_ns + S
    return op_idx, dense, sizes, is_write, n_tensors, (n if cyclic else 0)


# Process-wide stream cache: streams are pure functions of the trace (keyed
# by identity + op count like sweep._ANALYSES), and flattening them is
# Python-loop bound, so repeated sweeps over registry traces should never
# re-pay it. Bounded LRU — by entry count AND by a byte budget, so a long
# session sweeping many large ad-hoc traces cannot grow it without limit —
# with hit/miss/eviction counters (``stream_cache_stats``) so incremental
# build behavior is observable. Only default-kernel streams are cached
# (reference dist_fn calls from parity tests/benchmarks always rebuild).
# Value tuples carry the stream's byte estimate at insertion time (the scan
# layout attaches lazily afterwards, so the real footprint can be somewhat
# larger); a raw ``_STREAMS.clear()`` stays valid — bytes are summed from
# the stored entries, never kept as a separate running total.
_STREAMS: OrderedDict[
    tuple[int, int, bool, bool, str], tuple[Trace, TouchStream, int]
] = OrderedDict()
_STREAMS_MAX = 512
_STREAMS_MAX_BYTES = 256 * 1024 * 1024
_STREAM_COUNTERS = {"hits": 0, "misses": 0, "evictions": 0}


def stream_cache_stats() -> dict[str, int]:
    """Observable stream-cache state: hit/miss/eviction counters plus the
    current entry count, resident byte estimate, and configured bounds."""
    return {
        **_STREAM_COUNTERS,
        "entries": len(_STREAMS),
        "bytes": sum(nb for _, _, nb in _STREAMS.values()),
        "max_entries": _STREAMS_MAX,
        "max_bytes": _STREAMS_MAX_BYTES,
    }


def stream_cache_clear() -> None:
    """Drop every cached stream and zero the counters."""
    _STREAMS.clear()
    for k in _STREAM_COUNTERS:
        _STREAM_COUNTERS[k] = 0


def set_stream_cache_limit(max_entries: int | None = None,
                           max_bytes: int | None = None) -> None:
    """Re-bound the stream LRU (``None`` keeps a bound unchanged). Shrinking
    a bound evicts immediately from the LRU end."""
    global _STREAMS_MAX, _STREAMS_MAX_BYTES
    if max_entries is not None:
        _STREAMS_MAX = int(max_entries)
    if max_bytes is not None:
        _STREAMS_MAX_BYTES = int(max_bytes)
    _stream_cache_trim()


def _stream_cache_trim() -> None:
    total = sum(nb for _, _, nb in _STREAMS.values())
    while _STREAMS and (len(_STREAMS) > _STREAMS_MAX
                        or total > _STREAMS_MAX_BYTES):
        _, (_, _, nb) = _STREAMS.popitem(last=False)
        total -= nb
        _STREAM_COUNTERS["evictions"] += 1


def _stream_cache_get(trace: Trace, cyclic: bool, reuse_buffers: bool,
                      backend: str = "numpy") -> TouchStream | None:
    key = (id(trace), len(trace.ops), cyclic, reuse_buffers, backend)
    hit = _STREAMS.get(key)
    if hit is not None and hit[0] is trace:
        _STREAMS.move_to_end(key)
        _STREAM_COUNTERS["hits"] += 1
        return hit[1]
    _STREAM_COUNTERS["misses"] += 1
    return None


def _stream_cache_put(trace: Trace, cyclic: bool, reuse_buffers: bool,
                      stream: TouchStream, backend: str = "numpy") -> None:
    key = (id(trace), len(trace.ops), cyclic, reuse_buffers, backend)
    _STREAMS[key] = (trace, stream, int(stream.nbytes))
    _stream_cache_trim()


def build_stream(trace: Trace, cyclic: bool = True, reuse_buffers: bool = True,
                 dist_fn=_mattson_pass) -> TouchStream:
    """Tensors whose name starts with ``in.`` are *streaming*: fresh data
    arrives every iteration (input batches, labels), so consecutive
    iterations never reuse them — they get one tensor identity per iteration
    copy instead of wrapping around. Transient tensors share recycled buffer
    identities (see :func:`_assign_buffers`). ``dist_fn`` selects the Mattson
    implementation (the per-touch reference is used by parity/benchmark
    paths)."""
    default_kernel = dist_fn is _mattson_pass
    if default_kernel:
        hit = _stream_cache_get(trace, cyclic, reuse_buffers)
        if hit is not None:
            return hit
    op_idx, dense, sizes, is_write, n_tensors, second_half = _flatten_trace(
        trace, cyclic, reuse_buffers
    )
    dist = dist_fn(dense, sizes) if len(op_idx) else np.zeros(0)
    stream = TouchStream(
        n_ops=len(trace.ops),
        op_idx=op_idx,
        sizes=sizes,
        is_write=is_write,
        dist=dist,
        tensor_idx=dense,
        n_tensors=n_tensors,
        second_half=second_half,
    )
    if default_kernel:
        _stream_cache_put(trace, cyclic, reuse_buffers, stream)
    return stream


#: Streams at or below this (doubled) length run the batched Mattson kernel;
#: longer ones are work-dominated and the per-stream kernel is faster.
_BATCH_MATTSON_MAX_LEN = 1024


def _batch_width(n: int) -> int:
    """A stream's row width in the batch pass: the next power of two up to
    ``_BATCH_MATTSON_MAX_LEN``, its own length beyond."""
    return 1 << max(int(np.ceil(np.log2(n))), 0) if n <= _BATCH_MATTSON_MAX_LEN else n


def _mattson_blocks(rows: dict[int, np.ndarray]) -> list[list[int]]:
    """Group streams (index -> length-bearing array) into the batch pass's
    blocks: the short ones by pow2 width, each longer one alone."""
    blocks: dict[int, list[int]] = {}
    long: list[list[int]] = []
    for i, dense in rows.items():
        n = len(dense)
        if 0 < n <= _BATCH_MATTSON_MAX_LEN:
            blocks.setdefault(_batch_width(n), []).append(i)
        elif n:
            long.append([i])
    return list(blocks.values()) + long


def _padded_rows(members: list[int], rows: dict[int, tuple]) -> tuple[np.ndarray, np.ndarray]:
    """One block's ``(ids, sizes)`` padded to its widest member's width."""
    width = _batch_width(max(len(rows[i][0]) for i in members))
    ids2 = np.full((len(members), width), PAD_ID, dtype=np.int64)
    sz2 = np.zeros((len(members), width))
    for r, i in enumerate(members):
        dense, sizes = rows[i]
        ids2[r, : len(dense)] = dense
        sz2[r, : len(dense)] = sizes
    return ids2, sz2


def _host_distances(rows: dict[int, tuple[np.ndarray, np.ndarray]]) -> dict[int, np.ndarray]:
    """Every stream's distances (index -> ``(dense ids, sizes)``) from the
    NumPy passes: the short streams batched by pow2 width, each long one
    through the per-stream kernel, which is faster on the host once the
    merge levels are work-dominated."""
    dists = {i: _mattson_pass(*r) for i, r in rows.items() if len(r[0]) > _BATCH_MATTSON_MAX_LEN}
    for members in _mattson_blocks({i: r[0] for i, r in rows.items() if i not in dists}):
        dist2 = _mattson_pass_batch(*_padded_rows(members, rows))
        for r, i in enumerate(members):
            dists[i] = dist2[r, : len(rows[i][0])].copy()
    return dists


def _device_distances(rows: dict[int, tuple[np.ndarray, np.ndarray]],
                      device: torch.device) -> dict[int, np.ndarray]:
    """Every stream's distances (index -> ``(dense ids, sizes)``) from the
    batch pass on ``device``: one block per :func:`_mattson_blocks` group,
    uploaded once, and one copy back for all of them."""
    blocks = _mattson_blocks({i: r[0] for i, r in rows.items()})
    outs = []
    for members in blocks:
        ids2, sz2 = _padded_rows(members, rows)
        dist2 = _mattson_pass_batch_torch(torch.from_numpy(ids2).to(device),
                                          torch.from_numpy(sz2).to(device))
        outs.append(dist2.reshape(-1))
    host = torch.cat(outs).cpu().numpy() if outs else np.zeros(0)
    dists: dict[int, np.ndarray] = {}
    at = 0
    for members, out in zip(blocks, outs):
        width = out.numel() // len(members)
        for r, i in enumerate(members):
            dists[i] = host[at + r * width: at + r * width + len(rows[i][0])].copy()
        at += out.numel()
    return dists


def build_streams(traces: Sequence[Trace], cyclic: bool = True,
                  reuse_buffers: bool = True, device=None) -> list[TouchStream]:
    """Build every trace's :class:`TouchStream` with ONE batched Mattson
    pass over all short streams (grouped into padded pow2-width blocks;
    long streams keep the per-stream kernel, which is faster once the merge
    levels are work-dominated). Row results are bit-identical to
    :func:`build_stream` per trace — both land in the shared stream cache.

    ``device`` (``None``: the card) says where: ``"cpu"`` runs the NumPy
    passes above (:func:`_host_distances`); on the card every stream goes
    through the device batch pass, a long one as a block of its own
    (:func:`_device_distances`), and the streams are memoized under the
    card's key.
    """
    scan = scan_device(device)
    backend = _backend_key(scan)
    out: list[TouchStream | None] = [None] * len(traces)
    flat: dict[int, tuple] = {}
    for i, trace in enumerate(traces):
        hit = _stream_cache_get(trace, cyclic, reuse_buffers, backend)
        if hit is not None:
            out[i] = hit
        else:
            flat[i] = _flatten_trace(trace, cyclic, reuse_buffers)
    if not flat:
        return out
    rows = {i: (f[1], f[2]) for i, f in flat.items()}
    dists = _host_distances(rows) if scan is None else _device_distances(rows, scan)
    for i, (op_idx, dense, sizes, is_write, n_tensors, second_half) in flat.items():
        dist = dists.get(i, np.zeros(0))
        stream = TouchStream(
            n_ops=len(traces[i].ops),
            op_idx=op_idx,
            sizes=sizes,
            is_write=is_write,
            dist=dist,
            tensor_idx=dense,
            n_tensors=n_tensors,
            second_half=second_half,
        )
        _stream_cache_put(traces[i], cyclic, reuse_buffers, stream, backend)
        out[i] = stream
    return out


@dataclass
class LevelTraffic:
    """Per-op traffic crossing out the bottom of one cache level."""

    fill: np.ndarray        # bytes fetched per op (read misses)
    writeback: np.ndarray   # dirty bytes written back per op

    @property
    def total(self) -> float:
        return float(self.fill.sum() + self.writeback.sum())

    @property
    def total_fill(self) -> float:
        return float(self.fill.sum())

    @property
    def total_writeback(self) -> float:
        return float(self.writeback.sum())


def _reference_traffic_below(
    stream: TouchStream, capacities: list[float]
) -> list[LevelTraffic]:
    """Per-touch oracle for :func:`traffic_below` (sequential dirty-state
    recurrence carrying a (n_tensors x n_caps) state). Retained for parity
    tests and the before/after timing in ``benchmarks/bench_core.py``."""
    caps = np.asarray(capacities, dtype=np.float64)
    ncap = len(caps)
    fills = np.zeros((ncap, stream.n_ops))
    wbs = np.zeros((ncap, stream.n_ops))
    if len(stream.op_idx) == 0:
        return [LevelTraffic(fills[i], wbs[i]) for i in range(ncap)]

    dirty = np.zeros((stream.n_tensors, ncap))
    start_attrib = stream.second_half
    for t in range(len(stream.op_idx)):
        size = stream.sizes[t]
        d = stream.dist[t]
        x = stream.tensor_idx[t]
        op = stream.op_idx[t]
        record = t >= start_attrib
        if np.isinf(d):
            resident = np.zeros(ncap)
        else:
            resident = np.clip(caps - d, 0.0, size)
        evicted = size - resident
        wb_bytes = evicted * dirty[x]
        if record:
            wbs[:, op] += wb_bytes
        if stream.is_write[t]:
            if record:
                # full-tensor stores: no fill on write-allocate
                pass
            dirty[x] = 1.0
        else:
            if record:
                fills[:, op] += evicted
            # evicted dirty bytes were flushed; resident dirty bytes remain
            frac = np.divide(resident, size, out=np.zeros_like(resident), where=size > 0)
            dirty[x] = dirty[x] * frac
    return [LevelTraffic(fills[i], wbs[i]) for i in range(ncap)]


def traffic_below(stream: TouchStream, capacities: list[float]) -> list[LevelTraffic]:
    """Traffic leaving an LRU pool of each capacity, one trace pass total.

    Fully vectorized over (touches x capacities). The dirty fraction seen by
    a touch is a product of residency fractions along its tensor's chain of
    reads since the last write (writes reset it to 1, chain starts to 0), so
    grouping touches by tensor turns the sequential recurrence into a
    segmented cumulative-product scan: a log-space cumsum with per-segment
    base subtraction, plus an explicit zero counter so exact-zero fractions
    stay exact. Each capacity column is independent, so batching capacities
    is bit-identical to evaluating them one at a time — the property the
    sweep engine relies on to share one pass across a whole design space.
    """
    caps = np.asarray(capacities, dtype=np.float64)
    ncap = len(caps)
    n_ops = stream.n_ops
    n = len(stream.op_idx)
    if n == 0 or ncap == 0:
        return [LevelTraffic(np.zeros(n_ops), np.zeros(n_ops))
                for _ in range(ncap)]

    # Group touches by tensor, preserving time order inside each chain.
    order = np.argsort(stream.tensor_idx, kind="stable")
    sizes = stream.sizes[order]
    dist = stream.dist[order]
    is_write = stream.is_write[order]
    tid = stream.tensor_idx[order]
    op_idx = stream.op_idx[order]
    record = order >= stream.second_half

    # Residency per (touch, capacity); +inf distance -> nothing resident.
    with np.errstate(invalid="ignore"):  # inf cap - inf dist
        resident = np.clip(caps[None, :] - dist[:, None], 0.0, sizes[:, None])
    resident[np.isinf(dist)] = 0.0
    evicted = sizes[:, None] - resident
    frac = np.divide(
        resident, sizes[:, None], out=np.zeros_like(resident),
        where=sizes[:, None] > 0,
    )

    pos = np.arange(n)
    chain_start = np.maximum.accumulate(
        np.where(np.concatenate([[True], tid[1:] != tid[:-1]]), pos, 0)
    )
    # Last write strictly before each touch (global running max; valid only
    # when it falls inside the touch's own chain).
    last_write_incl = np.maximum.accumulate(np.where(is_write, pos, -1))
    last_write = np.concatenate([[-1], last_write_incl[:-1]])
    has_base = last_write >= chain_start

    # Segmented product of read fractions over (last_write, touch), in log
    # space; zero fractions tracked separately so they yield exactly 0.
    is_read_col = ~is_write[:, None]
    log_safe = np.log(np.where(is_read_col & (frac > 0), frac, 1.0))
    zero_read = is_read_col & (frac <= 0.0)
    log_cum = np.concatenate([np.zeros((1, ncap)), np.cumsum(log_safe, axis=0)])
    zero_cum = np.concatenate(
        [np.zeros((1, ncap), dtype=np.int64), np.cumsum(zero_read, axis=0)]
    )
    seg_lo = last_write + 1  # first read after the resetting write
    dirty = np.exp(log_cum[pos] - log_cum[seg_lo])
    dirty[(zero_cum[pos] - zero_cum[seg_lo]) > 0] = 0.0
    dirty[~has_base] = 0.0

    # Scatter recorded traffic back to (capacity, op): flat index c*n_ops+op,
    # one weighted bincount for writebacks and one for fills.
    cap_offsets = np.arange(ncap, dtype=np.int64)[None, :] * n_ops
    rec = np.nonzero(record)[0]
    flat = (op_idx[rec, None].astype(np.int64) + cap_offsets).ravel()
    wbs = np.bincount(
        flat, weights=(evicted[rec] * dirty[rec]).ravel(), minlength=ncap * n_ops
    ).reshape(ncap, n_ops)
    rd = np.nonzero(record & ~is_write)[0]
    flat_rd = (op_idx[rd, None].astype(np.int64) + cap_offsets).ravel()
    fills = np.bincount(
        flat_rd, weights=evicted[rd].ravel(), minlength=ncap * n_ops
    ).reshape(ncap, n_ops)
    return [LevelTraffic(fills[i], wbs[i]) for i in range(ncap)]


#: A block absorbs shorter streams down to this fraction of its width;
#: padding waste inside a block is bounded by 1/_BLOCK_FILL.
_BLOCK_FILL = 0.75

#: Row x width bound per block (keeps the (R, L, ncap) temporaries small).
_BLOCK_SLOTS = 1 << 20


@dataclass
class _PaddedBlock:
    """One same-width row block of a :class:`StreamBatch`, stored in
    tensor-sorted order with every capacity-independent quantity of the
    :func:`traffic_below` scan precomputed: the segment structure (chain
    starts, last writes) reduced to the recorded touches, and the scatter
    indices. A traffic call only runs the capacity-dependent residency and
    dirty math."""

    members: list[int]              # stream indices, same order as rows
    sizes: np.ndarray               # (R, L) float64, tensor-sorted, pads 0
    dist: np.ndarray                # (R, L) float64, pads +inf
    is_write: np.ndarray            # (R, L) bool, pads False
    is_inf: np.ndarray              # (R, L) bool: +inf distance
    # -- recorded (steady-state) touches, flattened --------------------------
    rec_rows: np.ndarray            # (n_rec,) block row of each recorded touch
    rec_cols: np.ndarray            # (n_rec,) sorted-position column
    seg_rec: np.ndarray             # (n_rec,) first read after the last write
    has_base_rec: np.ndarray        # (n_rec,) last write inside own chain
    iw_rec: np.ndarray              # (n_rec,) is-write flag
    sizes_rec: np.ndarray           # (n_rec,) touch bytes
    op_rec: np.ndarray              # (n_rec,) global op id
    # the arrays above that the scan reads, uploaded to the batch's device
    on_device: dict[str, torch.Tensor] | None = field(default=None, repr=False)


#: The :class:`_PaddedBlock` arrays a device scan reads (everything but
#: ``members``), uploaded once when the block is built.
_DEVICE_FIELDS = ("sizes", "dist", "is_write", "is_inf", "rec_rows", "rec_cols",
                  "seg_rec", "has_base_rec", "iw_rec", "sizes_rec", "op_rec")


def _block_traffic_torch(dev: dict[str, torch.Tensor], caps: torch.Tensor,
                         fills: torch.Tensor, wbs: torch.Tensor) -> None:
    """:meth:`StreamBatch._block_traffic` as torch operations on one
    block's uploaded arrays ``dev``: ``caps`` is float64 on their device,
    ``fills`` and ``wbs`` flat ``(n_capacities * n_ops_total,)`` float64
    accumulators there. The same steps in the same order; the masked log
    and exp become ``torch.where`` around the transcendental, and the
    weighted ``bincount`` an ``index_add_``. A +inf distance is zeroed
    through ``is_inf`` before any log (``cap - inf`` is NaN where the
    capacity is inf too). Fill bytes are whole numbers (sizes and
    capacities are), so their sums are exact in any order; writebacks go
    through ``log``/``exp`` and an unordered ``index_add_`` on the card."""
    ncap = caps.shape[0]
    n_ops_total = fills.shape[0] // ncap
    sizes3 = dev["sizes"][:, :, None]
    R = sizes3.shape[0]
    resident = torch.minimum((caps[None, None, :] - dev["dist"][:, :, None]).clamp_min(0.0),
                             sizes3)
    resident = resident.masked_fill(dev["is_inf"][:, :, None], 0.0)

    # log of the residency fraction, evaluated ONLY on partial reads.
    is_read3 = ~dev["is_write"][:, :, None]
    partial = (resident > 0.0) & (resident < sizes3) & is_read3
    log_safe = torch.log(torch.where(partial, resident / sizes3, 1.0))
    zero_read = is_read3 & (resident <= 0.0)

    # The prefix sums along the touches, (row, capacity) column by column.
    # CUDA scans a middle axis one thread a column, in order: a long row
    # would leave all but ncap threads idle. Only partial reads add a
    # nonzero log term and adding the zeros between them changes nothing,
    # so each column's terms are packed in order and scanned alone (still in
    # order: the sums are NumPy's, bit for bit); the zero-read counts are
    # integers and take the parallel scan along the last axis.
    partial_t = partial.permute(0, 2, 1)                     # (R, ncap, L)
    n_partial = torch.cumsum(partial_t, dim=2, dtype=torch.int32)
    n_zero = torch.cumsum(zero_read.permute(0, 2, 1), dim=2, dtype=torch.int32)
    depth = int(n_partial[:, :, -1].max())
    r, c, t = partial_t.nonzero(as_tuple=True)
    packed = resident.new_zeros((depth + 1, R * ncap))
    packed[n_partial[r, c, t].long(), r * ncap + c] = log_safe[r, t, c]
    log_cum = torch.cumsum(packed, dim=0)    # [k, column]: the column's first k terms

    # Segmented product at the recorded touches only: the sums before a
    # touch are the terms (and zero reads) before it.
    rows, cols, seg = dev["rec_rows"], dev["rec_cols"], dev["seg_rec"]
    column = rows[:, None] * ncap + torch.arange(ncap, device=caps.device)[None, :]

    def before(counts, flags, at):
        return counts[rows, :, at] - flags[rows, :, at].to(torch.int32)

    diff = log_cum[before(n_partial, partial_t, cols).long(), column] \
        - log_cum[before(n_partial, partial_t, seg).long(), column]
    dirty = torch.where(diff != 0.0, torch.exp(diff), 1.0)
    zero_t = zero_read.permute(0, 2, 1)
    dirty = dirty.masked_fill(before(n_zero, zero_t, cols) - before(n_zero, zero_t, seg) > 0,
                              0.0)
    dirty = dirty.masked_fill(~dev["has_base_rec"][:, None], 0.0)

    evicted = dev["sizes_rec"][:, None] - resident[rows, cols]
    cap_offsets = torch.arange(ncap, dtype=torch.int64, device=caps.device)[None, :] * n_ops_total
    flat = dev["op_rec"][:, None] + cap_offsets
    wbs.index_add_(0, flat.reshape(-1), (evicted * dirty).reshape(-1))
    rd = ~dev["iw_rec"]
    fills.index_add_(0, flat[rd].reshape(-1), evicted[rd].reshape(-1))


@dataclass
class StreamBatch:
    """A whole suite of touch streams padded into batched tensors.

    The suite-level counterpart of :class:`TouchStream`: every member
    stream's (doubled) touch arrays are padded to a common row width —
    sizes, op-segment ids (offset into one global op axis), write flags,
    reuse distances, and a validity/record mask per ``(n_traces, max_len)``
    row. Rows are grouped into similar-width blocks internally (a block
    only absorbs streams within ``_BLOCK_FILL`` of its width), so a
    registry that mixes 24-touch HPC proxies with 26k-touch MLPerf traces
    never pads a short stream to the longest one.

    :meth:`traffic_below` runs the segmented stack-distance/dirty-capacity
    scan of :func:`traffic_below` over the whole batch — every cumulative
    scan runs along the row axis, so each row is evaluated with exactly the
    float-operation sequence the per-trace kernel performs on that stream
    alone: results are bit-identical to per-trace calls (asserted in
    tests), which is what lets the sweep engine evaluate a whole registry
    in one trace x config x capacity pass. The sort and segment structure
    are capacity-independent, so :meth:`pad` computes them once; repeated
    sweeps pay only the residency/dirty math.

    ``device`` (a torch device, the CPU included) moves that math there:
    each block's arrays are uploaded once, when it is built, and
    :meth:`traffic_matrices` runs :func:`_block_traffic_torch` over them.
    ``None`` keeps the NumPy scan.
    """

    streams: list[TouchStream]
    op_offsets: np.ndarray          # (n_traces + 1,) int64 global op segments
    _blocks: list[_PaddedBlock] = field(default_factory=list, repr=False)
    device: torch.device | None = None

    @property
    def n_traces(self) -> int:
        return len(self.streams)

    @property
    def n_ops_total(self) -> int:
        return int(self.op_offsets[-1])

    def op_slice(self, i: int) -> slice:
        return slice(int(self.op_offsets[i]), int(self.op_offsets[i + 1]))

    @classmethod
    def pad(cls, streams: Iterable[TouchStream], device=None) -> "StreamBatch":
        streams = list(streams)
        op_offsets = np.zeros(len(streams) + 1, dtype=np.int64)
        if streams:
            np.cumsum(np.array([s.n_ops for s in streams], dtype=np.int64),
                      out=op_offsets[1:])
        batch = cls(streams=streams, op_offsets=op_offsets,
                    device=None if device is None else torch.device(device))
        batch._append_blocks(range(len(streams)))
        return batch

    def append(self, streams: Iterable[TouchStream]) -> list[_PaddedBlock]:
        """Append rows to a live batch: new streams extend the global op
        axis and are grouped into NEW blocks (same policy as :meth:`pad`
        over the new rows alone — existing blocks are never rebuilt). Row
        results are per-row, so the grown batch is bit-identical, stream
        for stream, to a cold :meth:`pad` of the full list (asserted in
        tests). Returns the blocks added, for partial (new-rows-only)
        :meth:`traffic_matrices` scans."""
        streams = list(streams)
        start = len(self.streams)
        self.streams.extend(streams)
        if streams:
            self.op_offsets = np.concatenate([
                self.op_offsets,
                self.op_offsets[-1] + np.cumsum(
                    np.array([s.n_ops for s in streams], dtype=np.int64)),
            ])
        k0 = len(self._blocks)
        self._append_blocks(range(start, len(self.streams)))
        return self._blocks[k0:]

    def _append_blocks(self, indices: Iterable[int]) -> None:
        # Group by length, longest first: a block absorbs streams down to
        # _BLOCK_FILL of its width (bounding padding waste) and splits when
        # its padded slot count would exceed _BLOCK_SLOTS (bounding the
        # temporaries of one scan).
        streams = self.streams
        by_len = sorted((i for i in indices if len(streams[i].op_idx)),
                        key=lambda i: -len(streams[i].op_idx))
        group: list[int] = []
        for i in by_len:
            n = len(streams[i].op_idx)
            if group:
                width = len(streams[group[0]].op_idx)
                if n < _BLOCK_FILL * width or \
                        (len(group) + 1) * width > _BLOCK_SLOTS:
                    self._blocks.append(self._build_block(group))
                    group = []
            group.append(i)
        if group:
            self._blocks.append(self._build_block(group))

    def _build_block(self, members: list[int]) -> _PaddedBlock:
        """Assemble one padded block from the members' cached
        :class:`_StreamLayout` rows: padded 2-D columns by row copy, the
        recorded-touch reductions by concatenation (np.nonzero on a 2-D
        mask is row-major, so per-row concatenation reproduces the old
        in-block ordering exactly). Pad cells keep their exact neutral
        values: zero size, +inf distance, not-a-write."""
        streams, op_offsets = self.streams, self.op_offsets
        lays = [_stream_layout(streams[i]) for i in members]
        width = lays[0].n
        shape = (len(members), width)
        sizes = np.zeros(shape)
        dist = np.full(shape, np.inf)
        is_write = np.zeros(shape, dtype=bool)
        is_inf = np.ones(shape, dtype=bool)
        for r, lay in enumerate(lays):
            n = lay.n
            sizes[r, :n] = lay.sizes
            dist[r, :n] = lay.dist
            is_write[r, :n] = lay.is_write
            is_inf[r, :n] = lay.is_inf
        counts = [len(lay.rec_cols) for lay in lays]
        block = _PaddedBlock(
            members=list(members),
            sizes=sizes,
            dist=dist,
            is_write=is_write,
            is_inf=is_inf,
            rec_rows=np.repeat(np.arange(len(members), dtype=np.int64),
                               counts),
            rec_cols=np.concatenate([lay.rec_cols for lay in lays]),
            seg_rec=np.concatenate([lay.seg_rec for lay in lays]),
            has_base_rec=np.concatenate([lay.has_base_rec for lay in lays]),
            iw_rec=np.concatenate([lay.iw_rec for lay in lays]),
            sizes_rec=np.concatenate([lay.sizes_rec for lay in lays]),
            op_rec=np.concatenate(
                [lay.op_rec + op_offsets[i] for lay, i in zip(lays, members)]),
        )
        if self.device is not None:
            block.on_device = {name: torch.from_numpy(getattr(block, name)).to(self.device)
                               for name in _DEVICE_FIELDS}
        return block

    def traffic_matrices(
        self, capacities: Sequence[float],
        blocks: Sequence[_PaddedBlock] | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One batched scan over all rows: per-op fill/writeback bytes as two
        ``(n_capacities, n_ops_total)`` matrices over the global op axis.
        Stream ``i``'s columns are ``op_slice(i)``. ``blocks`` restricts the
        scan to a subset of row blocks (appended rows) — other columns stay
        zero. On a batch's ``device`` the blocks accumulate there and the two
        matrices come back to the host in one copy."""
        caps = np.asarray(capacities, dtype=np.float64)
        ncap = len(caps)
        n_ops_total = self.n_ops_total
        if self.device is not None and ncap:
            caps_t = torch.from_numpy(caps).to(self.device)
            acc = torch.zeros((2, ncap * n_ops_total), dtype=torch.float64, device=self.device)
            for block in (self._blocks if blocks is None else blocks):
                _block_traffic_torch(block.on_device, caps_t, acc[0], acc[1])
            host = acc.cpu().numpy().reshape(2, ncap, n_ops_total)
            return host[0], host[1]
        fills = np.zeros((ncap, n_ops_total))
        wbs = np.zeros((ncap, n_ops_total))
        if ncap:
            for block in (self._blocks if blocks is None else blocks):
                self._block_traffic(block, caps, fills, wbs)
        return fills, wbs

    def traffic_below(self, capacities: Sequence[float]) -> list[list[LevelTraffic]]:
        """Per-stream, per-capacity traffic: one batched scan over all rows.

        Returns ``out[i][k]`` = :class:`LevelTraffic` of stream ``i`` under
        an LRU pool of ``capacities[k]`` — each bit-identical to
        ``traffic_below(streams[i], capacities)[k]``.
        """
        fills, wbs = self.traffic_matrices(capacities)
        return [
            [LevelTraffic(fills[k, self.op_slice(i)], wbs[k, self.op_slice(i)])
             for k in range(len(fills))]
            for i in range(self.n_traces)
        ]

    def dram_traffic(self, capacities: Sequence[float]) -> np.ndarray:
        """Total traffic below each capacity: a ``(n_traces, n_capacities)``
        tensor from one batched pass (the suite-level paper Fig 4)."""
        per = self.traffic_below(capacities)
        return np.array([[lt.total for lt in row] for row in per])

    @staticmethod
    def _block_traffic(block: _PaddedBlock, caps: np.ndarray,
                       fills: np.ndarray, wbs: np.ndarray) -> None:
        """The capacity-dependent half of the :func:`traffic_below` scan,
        batched over rows: per-row residency, the segmented log-space dirty
        product (cumsum along the row axis), one global scatter.

        Bit-identity with the per-trace kernel survives the masked
        evaluation tricks below because the skipped cells have *exact*
        values: ``log(1.0) == 0.0`` for fully-resident reads, and
        ``exp(0.0) == 1.0`` for segments without partial reads — only
        partial-residency cells (the narrow band ``0 < cap - dist < size``)
        ever see a transcendental. Pad slots have zero size and their own
        tensor chain, so they contribute exact zeros everywhere."""
        ncap = len(caps)
        sizes = block.sizes
        sizes3 = sizes[:, :, None]
        R, L = sizes.shape
        n_ops_total = fills.shape[1]

        with np.errstate(invalid="ignore"):  # inf cap - inf dist
            resident = np.clip(caps[None, None, :] - block.dist[:, :, None],
                               0.0, sizes3)
        resident[block.is_inf] = 0.0

        # log of the residency fraction, evaluated ONLY on partial reads.
        is_read3 = ~block.is_write[:, :, None]
        partial = (resident > 0.0) & (resident < sizes3) & is_read3
        log_safe = np.zeros_like(resident)
        np.divide(resident, sizes3, out=log_safe, where=partial)
        np.log(log_safe, out=log_safe, where=partial)
        zero_read = is_read3 & (resident <= 0.0)
        log_cum = np.concatenate(
            [np.zeros((R, 1, ncap)), np.cumsum(log_safe, axis=1)], axis=1
        )
        zero_cum = np.concatenate(
            [np.zeros((R, 1, ncap), dtype=np.int32),
             np.cumsum(zero_read, axis=1, dtype=np.int32)], axis=1
        )

        # Segmented product at the recorded touches only.
        rows, cols, seg = block.rec_rows, block.rec_cols, block.seg_rec
        diff = log_cum[rows, cols] - log_cum[rows, seg]
        dirty = np.ones_like(diff)
        np.exp(diff, out=dirty, where=diff != 0.0)
        dirty[(zero_cum[rows, cols] - zero_cum[rows, seg]) > 0] = 0.0
        dirty[~block.has_base_rec] = 0.0

        evicted = block.sizes_rec[:, None] - resident[rows, cols]
        cap_offsets = np.arange(ncap, dtype=np.int64)[None, :] * n_ops_total
        flat = (block.op_rec[:, None] + cap_offsets)
        wbs += np.bincount(
            flat.ravel(), weights=(evicted * dirty).ravel(),
            minlength=ncap * n_ops_total,
        ).reshape(ncap, n_ops_total)
        rd = ~block.iw_rec
        fills += np.bincount(
            flat[rd].ravel(), weights=evicted[rd].ravel(),
            minlength=ncap * n_ops_total,
        ).reshape(ncap, n_ops_total)


@dataclass
class HierarchyTraffic:
    """Traffic at each boundary of the §III-C memory system, per op."""

    l2_touch: np.ndarray          # bytes served by the L2 (all touches)
    post_l2: LevelTraffic         # traffic crossing the UHB link (or to DRAM)
    dram: LevelTraffic            # traffic reaching DRAM
    has_l3: bool

    @property
    def l3_bytes(self) -> float:
        """Bytes served by the L3 = post-L2 traffic that did not reach DRAM."""
        return max(self.post_l2.total - self.dram.total, 0.0)


def simulate_hierarchy(
    trace: Trace, spec: GpuSpec, cyclic: bool = True, stream: TouchStream | None = None
) -> HierarchyTraffic:
    """One-shot §III-C hierarchy simulation. Thin wrapper over the single
    implementation in :class:`~repro_torch.core.sweep.TraceAnalysis` (which adds
    capacity caching for sweeps)."""
    from repro_torch.core.sweep import TraceAnalysis  # lazy: sweep imports cachesim

    return TraceAnalysis(trace, cyclic=cyclic, stream=stream).hierarchy(spec)


def dram_traffic_sweep(
    trace: Trace, llc_capacities: list[float], cyclic: bool = True, device=None,
) -> dict[float, float]:
    """Total DRAM traffic vs LLC capacity (paper Fig 4). The LLC here is the
    union pool DRAM sees (L2, or L2+L3 when composed).

    Thin wrapper over the shared :class:`~repro_torch.core.sweep.TraceAnalysis`
    cache, so repeated sweeps of one trace (across figures, configs, tests)
    reuse the stream and every previously computed capacity."""
    from repro_torch.core.sweep import analysis_for  # lazy: sweep imports cachesim

    return analysis_for(trace, cyclic=cyclic, device=device).dram_traffic(
        list(llc_capacities))


def dram_traffic_sweep_suite(
    traces: Sequence[Trace], llc_capacities: Sequence[float],
    cyclic: bool = True, device=None,
) -> dict[str, dict[float, float]]:
    """Suite-level Fig 4: DRAM traffic vs LLC capacity for MANY traces from
    one padded :class:`StreamBatch` pass (bit-identical, per trace, to
    :func:`dram_traffic_sweep`). Returns ``{trace_name: {capacity: bytes}}``
    in input order."""
    from repro_torch.core.sweep import suite_analysis_for  # lazy: sweep imports us

    traces = list(traces)
    caps = [float(c) for c in llc_capacities]
    mat = suite_analysis_for(traces, cyclic=cyclic, device=device).dram_traffic(caps)
    return {t.name: {c: float(v) for c, v in zip(caps, mat[i])}
            for i, t in enumerate(traces)}
