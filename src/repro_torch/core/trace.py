"""Tensor-granular access-trace IR.

The paper evaluates one *end-to-end iteration* of each workload through a
trace-driven memory-hierarchy simulator, explicitly to capture inter-kernel
reuse (§IV-A). We reproduce that with a deterministic, analytic trace: a
sequence of :class:`Op` records, each reading/writing named logical tensors.

Granularity: one Op ≈ one GPU kernel (a GEMM, a conv, a fused elementwise
group). DL traffic streams over large tensors, so tensor-level touches (with
fractional residency inside the cache model) are the natural unit — the
cache model in ``cachesim.py`` is calibrated against an exact block-level LRU
in the tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

BYTES = {"fp32": 4, "tf32": 4, "fp16": 2, "bf16": 2, "int8": 1, "fp8": 1}


@dataclass(frozen=True)
class TouchTable:
    """:meth:`Trace.touch_table`: the trace's touches as flat arrays.

    One slim Python pass builds the raw columns; every per-tensor statistic
    the cache model needs (first/last touch, max size, first-is-write) is
    derived vectorized. ``name_id`` interns tensor names in first-appearance
    order — the dense-id convention the flatten/recycling passes in
    ``repro.core.cachesim`` build on.
    """

    op_idx: np.ndarray        # (n,) int32 op index per touch
    name_id: np.ndarray       # (n,) int64 first-appearance interned name id
    sizes: np.ndarray         # (n,) float64 touch bytes
    is_write: np.ndarray      # (n,) bool
    names: list[str]          # id -> tensor name (first-appearance order)
    stream_flag: np.ndarray   # (K,) bool: name starts with "in."
    first: np.ndarray         # (K,) int64 first touch position
    last: np.ndarray          # (K,) int64 last touch position
    max_size: np.ndarray      # (K,) float64 max touch bytes of the tensor
    first_is_write: np.ndarray  # (K,) bool
    has_buf_names: bool       # any real tensor named like a recycled buffer

    @property
    def n_touches(self) -> int:
        return len(self.op_idx)

    @property
    def n_names(self) -> int:
        return len(self.names)


@dataclass(frozen=True)
class Op:
    """One kernel launch: FLOPs plus the tensors it touches.

    ``reads``/``writes`` are tuples of ``(tensor_name, nbytes)``. A tensor
    that is accumulated in place (e.g. a weight-gradient buffer) appears in
    both. ``parallelism`` is the number of concurrent scalar lanes the kernel
    can fill; the perf model turns it into an SM-occupancy factor.
    """

    name: str
    flops: float
    reads: tuple[tuple[str, int], ...] = ()
    writes: tuple[tuple[str, int], ...] = ()
    precision: str = "fp16"
    parallelism: float = float("inf")

    @property
    def read_bytes(self) -> int:
        return sum(b for _, b in self.reads)

    @property
    def write_bytes(self) -> int:
        return sum(b for _, b in self.writes)

    @property
    def touch_bytes(self) -> int:
        return self.read_bytes + self.write_bytes


@dataclass
class Trace:
    """One end-to-end iteration of a workload."""

    name: str
    ops: list[Op] = field(default_factory=list)
    # Metadata for reporting; not used by the simulator itself.
    batch_size: int = 0
    kind: str = "training"  # "training" | "inference"

    # -- builders -------------------------------------------------------------
    def emit(
        self,
        name: str,
        flops: float,
        reads: Sequence[tuple[str, int]] = (),
        writes: Sequence[tuple[str, int]] = (),
        precision: str = "fp16",
        parallelism: float | None = None,
    ) -> Op:
        if parallelism is None:
            # Default: one lane per output element (elementwise-ish kernels);
            # matmul/conv builders pass an explicit tile-level parallelism.
            elems = sum(b for _, b in writes) / max(BYTES.get(precision, 2), 1)
            parallelism = max(elems, 1.0)
        op = Op(
            name=name,
            flops=float(flops),
            reads=tuple((t, int(b)) for t, b in reads if b > 0),
            writes=tuple((t, int(b)) for t, b in writes if b > 0),
            precision=precision,
            parallelism=float(parallelism),
        )
        self.ops.append(op)
        return op

    # -- aggregate properties --------------------------------------------------
    @property
    def total_flops(self) -> float:
        return sum(op.flops for op in self.ops)

    @property
    def total_touch_bytes(self) -> int:
        return sum(op.touch_bytes for op in self.ops)

    def footprint_bytes(self) -> int:
        """Unique bytes across all tensors (upper bound, no buffer reuse)."""
        seen: dict[str, int] = {}
        for op in self.ops:
            for t, b in op.reads + op.writes:
                seen[t] = max(seen.get(t, 0), b)
        return sum(seen.values())

    def peak_live_bytes(self) -> int:
        """Allocator-peak proxy: a tensor is live from its first to its last
        touch; persistent tensors (weights, optimizer state — anything both
        read and written, or read before written) are live throughout. This
        matches how the paper reports per-GPU 'memory footprint' (Table III).
        """
        first: dict[str, int] = {}
        last: dict[str, int] = {}
        size: dict[str, int] = {}
        persistent: set[str] = set()
        written: set[str] = set()
        for i, op in enumerate(self.ops):
            for t, b in op.reads:
                first.setdefault(t, i)
                last[t] = i
                size[t] = max(size.get(t, 0), b)
                if t not in written:
                    persistent.add(t)  # read before ever written: lives across iters
            for t, b in op.writes:
                first.setdefault(t, i)
                last[t] = i
                size[t] = max(size.get(t, 0), b)
                written.add(t)
        n = len(self.ops)
        delta = [0] * (n + 1)
        base = 0
        for t, s in size.items():
            if t in persistent:
                base += s
            else:
                delta[first[t]] += s
                delta[last[t] + 1] -= s
        peak, cur = 0, 0
        for i in range(n):
            cur += delta[i]
            peak = max(peak, cur)
        return base + peak

    def touches(self) -> Iterable[tuple[int, str, int, bool]]:
        """Flatten to (op_index, tensor, nbytes, is_write), reads first."""
        for i, op in enumerate(self.ops):
            for t, b in op.reads:
                yield i, t, b, False
            for t, b in op.writes:
                yield i, t, b, True

    def touch_table(self) -> TouchTable:
        """Flat touch arrays + per-tensor stats, cached on the trace.

        Same touch order as :meth:`touches` (reads before writes per op).
        Keyed by op count like the analysis caches: a trace that grows via
        :meth:`emit` gets a fresh table; in-place edits of existing ops are
        on the caller.
        """
        cached = self.__dict__.get("_touch_table")
        if cached is not None and cached[0] == len(self.ops):
            return cached[1]
        rw = [op.reads + op.writes for op in self.ops]
        counts = np.fromiter((len(x) for x in rw), dtype=np.int64,
                             count=len(rw))
        n = int(counts.sum())
        intern: dict[str, int] = {}
        name_id = np.fromiter(
            (intern.setdefault(t, len(intern)) for x in rw for t, _ in x),
            dtype=np.int64, count=n)
        sizes = np.fromiter((b for x in rw for _, b in x),
                            dtype=np.float64, count=n)
        op_idx = np.repeat(np.arange(len(rw), dtype=np.int32), counts)
        n_reads = np.fromiter((len(op.reads) for op in self.ops),
                              dtype=np.int64, count=len(rw))
        op_start = np.cumsum(counts) - counts
        pos = np.arange(n, dtype=np.int64)
        is_write = pos - np.repeat(op_start, counts) >= np.repeat(n_reads,
                                                                  counts)
        K = len(intern)
        if n:
            # name_id is first-appearance interned, so np.unique's sorted
            # uniques are exactly 0..K-1 and return_index gives first touches.
            first = np.unique(name_id, return_index=True)[1]
            last = (n - 1) - np.unique(name_id[::-1], return_index=True)[1]
        else:
            first = np.zeros(0, dtype=np.int64)
            last = np.zeros(0, dtype=np.int64)
        max_size = np.zeros(K)
        np.maximum.at(max_size, name_id, sizes)
        table = TouchTable(
            op_idx=op_idx,
            name_id=name_id,
            sizes=sizes,
            is_write=is_write,
            names=list(intern),
            stream_flag=np.fromiter((t.startswith("in.") for t in intern),
                                    dtype=bool, count=K),
            first=first,
            last=last,
            max_size=max_size,
            first_is_write=is_write[first] if n else np.zeros(0, dtype=bool),
            has_buf_names=any(t.startswith("__buf") for t in intern),
        )
        self.__dict__["_touch_table"] = (len(self.ops), table)
        return table

    def scaled(self, name: str, flop_scale: float, byte_scale: float) -> "Trace":
        """Uniformly scaled copy (used for projection sensitivity tests)."""
        out = Trace(name=name, batch_size=self.batch_size, kind=self.kind)
        for op in self.ops:
            out.ops.append(
                Op(
                    name=op.name,
                    flops=op.flops * flop_scale,
                    reads=tuple((t, int(b * byte_scale)) for t, b in op.reads),
                    writes=tuple((t, int(b * byte_scale)) for t, b in op.writes),
                    precision=op.precision,
                    parallelism=op.parallelism,
                )
            )
        return out


def gemm_parallelism(m: int, n: int) -> float:
    """Concurrency exposed by an (m,n) output GEMM tiled 128x128 per CTA.

    Each 128x128 output tile occupies one CTA of ~256 threads on the modeled
    machine; the returned number is in scalar-lane units comparable to
    ``GpuSpec.concurrency``.
    """
    tiles = math.ceil(m / 128) * math.ceil(n / 128)
    return float(tiles * 256)
