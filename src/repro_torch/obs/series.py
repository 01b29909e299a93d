"""Windowed metric rollups: when did the SLO break, not just whether.

:func:`timeseries` buckets a finished run into fixed-width windows over
``[t_first_arrival, t_last_done]`` and reduces each bucket with pure numpy
(bincounts for the per-request columns, an interval-overlap accumulation
for the step-log integrals) — part of the post-hoc derivation priced on
the ``serving.obs.*`` bench row.

Exactness contract (property-tested for arbitrary ``window_s``): requests
are assigned to windows by clipped ``floor((t - t0) / window_s)``, so the
per-window ``arrived`` / ``completed`` / ``ok`` / ``tokens`` /
``evictions`` columns sum EXACTLY to the aggregate
:class:`~repro_torch.serve.sim.SimMetrics` values — no request is ever lost to
edge rounding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MetricSeries:
    """Per-window rollup of one run. Rates are per second of window."""

    window_s: float
    t0: float                    # absolute left edge of window 0
    t1: float                    # end of the covered span (last done)
    n_instances: int             # initial fleet size the capacity tracks
    # -- per-request columns, bucketed -----------------------------------------
    arrived: np.ndarray          # requests arriving in the window
    completed: np.ndarray        # requests completing in the window
    ok: np.ndarray               # completions meeting the SLO (0s w/o slo)
    tokens: np.ndarray           # output tokens of those completions
    evictions: np.ndarray        # evictions of those completions
    ttft_p50: np.ndarray         # NaN where a window has no completions
    ttft_p95: np.ndarray
    tpot_p95: np.ndarray
    # -- step-log integrals ----------------------------------------------------
    busy_s: np.ndarray           # instance-seconds spent stepping
    capacity_s: np.ndarray       # instance-seconds available (fleet integral)
    batch_mean: np.ndarray       # busy-time-weighted running batch
    queue_mean: np.ndarray       # busy-time-weighted waiting-queue depth
    has_slo: bool = field(default=False)

    def __len__(self) -> int:
        return len(self.arrived)

    @property
    def t_start(self) -> np.ndarray:
        """Absolute left edge of every window."""
        return self.t0 + self.window_s * np.arange(len(self))

    @property
    def throughput_rps(self) -> np.ndarray:
        return self.completed / self.window_s

    @property
    def goodput_rps(self) -> np.ndarray:
        return self.ok / self.window_s

    @property
    def tokens_per_s(self) -> np.ndarray:
        return self.tokens / self.window_s

    @property
    def eviction_rate_rps(self) -> np.ndarray:
        return self.evictions / self.window_s

    @property
    def utilization(self) -> np.ndarray:
        """busy instance-seconds / available instance-seconds (NaN when a
        window has no capacity, e.g. past the end of the run)."""
        return np.divide(self.busy_s, self.capacity_s,
                         out=np.full(len(self), np.nan),
                         where=self.capacity_s > 0)

    def rows(self) -> list[dict]:
        out = []
        t_start = self.t_start
        util = self.utilization
        for j in range(len(self)):
            out.append({
                "t_start_s": float(t_start[j]),
                "arrived": int(self.arrived[j]),
                "completed": int(self.completed[j]),
                "ok": int(self.ok[j]),
                "throughput_rps": float(self.throughput_rps[j]),
                "goodput_rps": float(self.goodput_rps[j]),
                "tokens_per_s": float(self.tokens_per_s[j]),
                "evictions": int(self.evictions[j]),
                "ttft_p50_s": float(self.ttft_p50[j]),
                "ttft_p95_s": float(self.ttft_p95[j]),
                "tpot_p95_s": float(self.tpot_p95[j]),
                "batch_mean": float(self.batch_mean[j]),
                "queue_mean": float(self.queue_mean[j]),
                "utilization": float(util[j]),
            })
        return out

    def to_json(self) -> dict:
        return {
            "schema": "repro.obs.timeseries/v1",    # the JAX package's format name
            "window_s": self.window_s,
            "t0_s": self.t0,
            "n_windows": len(self),
            "n_instances_initial": self.n_instances,
            "has_slo": self.has_slo,
            "windows": self.rows(),
        }

    def table(self) -> str:
        """Text table, one row per window."""
        hdr = (f"{'t+':>8s} {'arr':>6s} {'done':>6s} "
               f"{'ok' if self.has_slo else '-':>6s} {'thru r/s':>9s} "
               f"{'good r/s':>9s} {'tok/s':>9s} {'ttft p95':>9s} "
               f"{'batch':>6s} {'queue':>7s} {'util':>5s} {'evict':>5s}")
        lines = [hdr, "-" * len(hdr)]
        t_rel = self.t_start - self.t0
        util = self.utilization
        for j in range(len(self)):
            u = f"{util[j]:5.0%}" if np.isfinite(util[j]) else "    -"
            p95 = f"{self.ttft_p95[j]:8.3f}s" \
                if np.isfinite(self.ttft_p95[j]) else "        -"
            lines.append(
                f"{t_rel[j]:7.1f}s {self.arrived[j]:6d} "
                f"{self.completed[j]:6d} "
                f"{(self.ok[j] if self.has_slo else 0):6d} "
                f"{self.throughput_rps[j]:9.1f} {self.goodput_rps[j]:9.1f} "
                f"{self.tokens_per_s[j]:9.0f} {p95} "
                f"{self.batch_mean[j]:6.1f} {self.queue_mean[j]:7.1f} "
                f"{u} {self.evictions[j]:5d}")
        return "\n".join(lines)


def _window_percentiles(vals: np.ndarray, widx: np.ndarray, n_win: int,
                        p: float) -> np.ndarray:
    """Per-window ``p``-th percentile of ``vals`` grouped by ``widx``
    (NaN for empty windows) — one stable argsort, then per-window slices."""
    out = np.full(n_win, np.nan)
    if len(vals) == 0:
        return out
    order = np.argsort(widx, kind="stable")
    sv = vals[order]
    sw = widx[order]
    bounds = np.searchsorted(sw, np.arange(n_win + 1))
    for j in range(n_win):
        lo, hi = bounds[j], bounds[j + 1]
        if hi > lo:
            out[j] = np.percentile(sv[lo:hi], p)
    return out


def _overlap_integrals(a: np.ndarray, b: np.ndarray,
                       weights: list[np.ndarray], t0: float, w: float,
                       n_win: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """Per-window overlap integrals for intervals ``[a, b)`` carrying
    constant per-interval ``weights``: returns (duration integral, one
    weighted integral per weight array). Within-window intervals accumulate
    vectorized; only boundary-crossing intervals (rare for windows much
    wider than a step) walk their window range in Python."""
    dur = np.zeros(n_win)
    outs = [np.zeros(n_win) for _ in weights]
    if len(a) == 0 or n_win == 0:
        return dur, outs
    ia = np.clip(((a - t0) // w).astype(np.int64), 0, n_win - 1)
    ib = np.clip(((b - t0) // w).astype(np.int64), 0, n_win - 1)
    d = b - a
    same = ia == ib
    np.add.at(dur, ia[same], d[same])
    for o, wt in zip(outs, weights):
        np.add.at(o, ia[same], (d * wt)[same])
    cross = np.nonzero(~same)[0]
    if len(cross):
        edges = t0 + w * np.arange(n_win + 1)
        for k in cross.tolist():
            lo, hi = a[k], b[k]
            for j in range(int(ia[k]), int(ib[k]) + 1):
                seg = min(hi, edges[j + 1]) - max(lo, edges[j])
                if seg > 0:
                    dur[j] += seg
                    for o, wt in zip(outs, weights):
                        o[j] += seg * wt[k]
    return dur, outs


def timeseries(result, window_s: float, *, slo=None) -> MetricSeries:
    """Windowed rollup of a ``SimResult``/``FleetResult`` (see module
    docstring for the exact-sum contract). ``slo`` enables the ``ok`` /
    goodput columns (a :class:`~repro_torch.serve.sim.Slo`)."""
    from repro_torch.obs.timeline import _unpack

    w = float(window_s)
    if not (w > 0 and np.isfinite(w)):
        raise ValueError(f"window_s must be finite and > 0, got {window_s!r}")
    batch, logs, events = _unpack(result)
    m = result.metrics
    n = len(batch)
    n_init = getattr(result, "n_instances_initial", None)
    if n_init is None:
        n_init = max(len(logs), 1)

    if n == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return MetricSeries(window_s=w, t0=0.0, t1=0.0,
                            n_instances=n_init, arrived=zi, completed=zi,
                            ok=zi, tokens=zi, evictions=zi, ttft_p50=z,
                            ttft_p95=z, tpot_p95=z, busy_s=z, capacity_s=z,
                            batch_mean=z, queue_mean=z,
                            has_slo=slo is not None)

    t0, t1 = m.t_first_arrival, m.t_last_done
    n_win = max(1, int(np.ceil((t1 - t0) / w))) if t1 > t0 else 1

    def widx(t):
        return np.clip(((t - t0) // w).astype(np.int64), 0, n_win - 1)

    wa = widx(batch.t_arrival)
    wc = widx(batch.t_done)
    arrived = np.bincount(wa, minlength=n_win)
    completed = np.bincount(wc, minlength=n_win)
    tokens = np.bincount(wc, weights=batch.output_tokens,
                         minlength=n_win).astype(np.int64)
    evicts = np.bincount(wc, weights=batch.evictions,
                         minlength=n_win).astype(np.int64)
    if slo is not None:
        ok = np.bincount(wc, weights=slo.ok_mask(m),
                         minlength=n_win).astype(np.int64)
    else:
        ok = np.zeros(n_win, dtype=np.int64)

    ttft_p50 = _window_percentiles(m.ttft, wc, n_win, 50)
    ttft_p95 = _window_percentiles(m.ttft, wc, n_win, 95)
    multi = m.output_tokens > 1
    tpot_p95 = _window_percentiles(m.tpot[multi], wc[multi], n_win, 95)

    # -- step-log integrals (busy time, running batch, queue depth) ------------
    if logs and any(len(sl.t_start) for sl in logs):
        a = np.concatenate([sl.t_start for sl in logs])
        bnd = np.concatenate([sl.t_end for sl in logs])
        bsz = np.concatenate([sl.batch for sl in logs]).astype(float)
        qd = np.concatenate([sl.queued for sl in logs]).astype(float)
        busy, (bint, qint) = _overlap_integrals(a, bnd, [bsz, qd],
                                                t0, w, n_win)
    else:
        busy = np.zeros(n_win)
        bint = qint = np.zeros(n_win)
    batch_mean = np.divide(bint, busy, out=np.zeros(n_win), where=busy > 0)
    queue_mean = np.divide(qint, busy, out=np.zeros(n_win), where=busy > 0)

    # -- fleet capacity integral over [t0, t1] (autoscale-aware) ---------------
    if events:
        st = np.array([e.t for e in events], dtype=float)
        sn = np.array([e.n_active for e in events], dtype=float)
        starts = np.concatenate([[t0], st])
        ends = np.minimum(np.concatenate([st, [t1]]), t1)
        vals = np.concatenate([[float(n_init)], sn])
    else:
        starts = np.array([t0])
        ends = np.array([t1])
        vals = np.array([float(n_init)])
    keep = ends > starts
    _, (capacity,) = _overlap_integrals(starts[keep], ends[keep],
                                        [vals[keep]], t0, w, n_win)

    return MetricSeries(window_s=w, t0=t0, t1=t1, n_instances=int(n_init),
                        arrived=arrived, completed=completed, ok=ok,
                        tokens=tokens, evictions=evicts, ttft_p50=ttft_p50,
                        ttft_p95=ttft_p95, tpot_p95=tpot_p95, busy_s=busy,
                        capacity_s=capacity, batch_mean=batch_mean,
                        queue_mean=queue_mean, has_slo=slo is not None)
