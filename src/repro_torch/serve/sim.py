"""Request-level serving simulator: continuous batching over analytic costs.

The sweep engine prices one *step* of a serving workload (a batched decode
iteration of a ``serve.*`` scenario) per COPA config. This module turns those
step costs into what a latency-bounded service actually sees: open-loop
arrivals queue at an instance, a continuous-batching scheduler admits them
into the running batch at step boundaries (bounded by ``max_batch`` and KV
residency), and every completed request carries TTFT / TPOT / E2E timings.

Layering:

* :class:`Request` / :class:`ArrivalSpec` — open-loop arrival processes
  (Poisson, deterministically-modulated bursts, replayed traces) with
  configurable prompt/output length distributions. Everything is seeded and
  deterministic.
* :class:`Instance` — ONE serving instance's scheduler state (FIFO waiting
  queue, running batch, KV residency via a ``repro_torch.serve.paged`` allocator:
  scalar full reservation by default, a block-table :class:`~repro_torch.serve.
  paged.PagedKv` when a :class:`~repro_torch.serve.paged.PagedKvSpec` is given).
  Step costs come from any object with the
  :class:`~repro_torch.core.sweep.CostGrid` interface: ``max_batch``,
  ``step_time(batch, resident_tokens)``, ``prefill_time(prompt_tokens)``.
* :func:`simulate` — the single-instance discrete-event loop (heap of
  arrival/step-completion events). ``repro_torch.serve.fleet`` layers N instances
  behind a router on the same :class:`Instance` mechanics.
* :func:`_reference_sim` — closed-form single-request oracle the event loop
  is tested against, matching the codebase's engine/oracle pattern.

Scheduling model (one engine iteration):

* at a step boundary the instance first resolves page pressure (paged KV
  with ``oversubscription > 1`` may evict the least-recently-admitted
  running request back to the FRONT of the waiting queue — its KV is
  recomputed at re-admission), then admits waiting requests FIFO while the
  batch has a slot and the allocator accepts the request's committed
  footprint (full ``prompt + output`` reservation by default; peak *pages*
  against an oversubscribable commit budget when paged);
* the iteration interleaves prefill and decode: its duration is the decode
  step cost at the (batch, resident-KV) grid cell plus the prefill cost of
  every prompt chunk consumed this step (whole prompts at admission by
  default; bounded by ``SchedPolicy.prefill_chunk`` when chunked);
* every running request that is past its prompt emits one token per
  iteration; the first token of a request is produced by the iteration
  that consumed its last prompt chunk (TTFT = queue wait + prefill + one
  decode step).

Residency/scheduling policies live in ``repro_torch.serve.paged`` — see its
docstring for the paged-KV model and the parity contract (``page_size=1``
with oversubscription disabled reproduces the reservation path
bit-for-bit).

The JAX reference package's module, host-side and free of tensor work. The
fleet simulator (``serve.fleet``, ``serve.fleetbatch``) and the windowed
``obs`` rollup (the reference's ``SimResult.timeseries``) are not ported
yet.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass, replace
from typing import Iterable, Sequence

import numpy as np

from repro_torch.serve.paged import PagedKvSpec, SchedPolicy, make_allocator

NAN = float("nan")


@dataclass
class Request:
    """One serving request. ``output_tokens`` engine iterations complete it;
    the paper-style one-shot scenarios (an MLPerf inference sample) are the
    ``prompt_tokens=0, output_tokens=1`` special case."""

    rid: int
    t_arrival: float
    prompt_tokens: int = 0
    output_tokens: int = 1
    # -- filled in by the simulator -------------------------------------------
    t_admitted: float = NAN
    t_first_token: float = NAN
    t_done: float = NAN
    tokens_emitted: int = 0
    evictions: int = 0          # paged KV: times evicted (recompute count)

    def __post_init__(self):
        if self.output_tokens < 1:
            raise ValueError("output_tokens must be >= 1")
        if self.prompt_tokens < 0 or self.t_arrival < 0:
            raise ValueError("prompt_tokens/t_arrival must be >= 0")

    @property
    def kv_tokens(self) -> int:
        """Peak KV residency this request reserves at admission."""
        return self.prompt_tokens + self.output_tokens


# -- length distributions ------------------------------------------------------

@dataclass(frozen=True)
class LengthDist:
    """Token-length distribution: ``fixed`` (mean), ``uniform`` [low, high],
    or ``lognormal`` (mean, sigma of the underlying normal). Samples are
    clipped to >= ``floor``."""

    kind: str = "fixed"
    mean: float = 1.0
    low: int = 1
    high: int = 1
    sigma: float = 0.5
    floor: int = 0

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "fixed":
            out = np.full(n, int(round(self.mean)))
        elif self.kind == "uniform":
            out = rng.integers(self.low, self.high + 1, n)
        elif self.kind == "lognormal":
            mu = math.log(max(self.mean, 1e-9)) - 0.5 * self.sigma ** 2
            out = np.rint(rng.lognormal(mu, self.sigma, n)).astype(np.int64)
        else:
            raise ValueError(f"unknown length distribution {self.kind!r}")
        return np.maximum(out.astype(np.int64), self.floor)


ONE_SHOT_PROMPT = LengthDist("fixed", mean=0, floor=0)
ONE_SHOT_OUTPUT = LengthDist("fixed", mean=1, floor=1)


@dataclass(frozen=True)
class ArrivalSpec:
    """An open-loop arrival process: ``generate(seed)`` materializes a
    deterministic request list.

    ``burst_factor``/``burst_fraction``/``period_s`` modulate a Poisson
    process: within each period the first ``burst_fraction`` runs at
    ``burst_factor`` x the off-phase rate, with the off-phase rate chosen so
    the long-run mean stays ``rate``. ``profile`` generalizes that to any
    piecewise-constant shape: a tuple of relative rate multipliers spread
    evenly over ``period_s`` (normalized so the long-run mean stays
    ``rate``) — a recorded diurnal load curve, say. The default is a plain
    (homogeneous) Poisson process."""

    name: str
    rate: float                       # mean requests/s
    n_requests: int
    prompt: LengthDist = ONE_SHOT_PROMPT
    output: LengthDist = ONE_SHOT_OUTPUT
    burst_factor: float = 1.0
    burst_fraction: float = 0.0
    period_s: float = 0.0
    profile: tuple[float, ...] = ()   # piecewise-constant relative rates

    def __post_init__(self):
        if self.profile:
            prof = np.asarray(self.profile, dtype=float)
            if (prof < 0).any() or prof.max() <= 0:
                raise ValueError(
                    "profile multipliers must be >= 0 with at least one > 0")
            if self.period_s <= 0:
                raise ValueError("profile needs period_s > 0")

    def with_rate(self, rate: float) -> "ArrivalSpec":
        return replace(self, rate=float(rate))

    def _thin_keep(self, t: np.ndarray, peak: float) -> np.ndarray:
        """Instantaneous rate at time ``t`` as a fraction of ``peak``."""
        phase = np.mod(t, self.period_s) / self.period_s
        if self.profile:
            prof = np.asarray(self.profile, dtype=float)
            idx = np.minimum((phase * len(prof)).astype(np.int64),
                             len(prof) - 1)
            return (self.rate * prof[idx] / prof.mean()) / peak
        frac, bf = self.burst_fraction, self.burst_factor
        # off-phase rate keeping the long-run mean at self.rate
        r_off = self.rate / (frac * bf + (1.0 - frac))
        r_on = bf * r_off
        return np.where(phase < frac, r_on, r_off) / peak

    def _sample_arrays(self, seed: int) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
        rng = np.random.default_rng(seed)
        n = self.n_requests
        bursty = bool(self.profile) or (
            self.burst_fraction > 0 and self.burst_factor != 1.0
            and self.period_s > 0)
        if not bursty:
            times = np.cumsum(rng.exponential(1.0 / self.rate, n))
        else:
            # Thinning (Lewis-Shedler): draw at the peak rate, keep with
            # probability rate(t)/peak — exact for piecewise-constant rates.
            if self.profile:
                prof = np.asarray(self.profile, dtype=float)
                peak = self.rate * prof.max() / prof.mean()
            else:
                frac, bf = self.burst_fraction, self.burst_factor
                peak = bf * self.rate / (frac * bf + (1.0 - frac))
            times_l, t, kept = [], 0.0, 0
            while kept < n:
                block = max(n - kept, 64) * 2
                gaps = rng.exponential(1.0 / peak, block)
                cand = t + np.cumsum(gaps)
                keep = rng.random(block) < self._thin_keep(cand, peak)
                sel = cand[keep][: n - kept]
                times_l.append(sel)
                kept += len(sel)
                t = float(cand[-1])
            times = np.concatenate(times_l)
        prompts = self.prompt.sample(rng, n)
        outputs = self.output.sample(rng, n)
        return times, prompts, outputs

    def generate(self, seed: int = 0) -> list[Request]:
        times, prompts, outputs = self._sample_arrays(seed)
        return [Request(rid=i, t_arrival=float(times[i]),
                        prompt_tokens=int(prompts[i]),
                        output_tokens=int(outputs[i]))
                for i in range(self.n_requests)]

    def generate_batch(self, seed: int = 0) -> "RequestBatch":
        """Materialize the same request stream as :meth:`generate` (identical
        RNG draws) straight into struct-of-arrays form — no per-request
        Python objects, which is what lets planet-scale fleet runs price
        100k-request traces cheaply."""
        times, prompts, outputs = self._sample_arrays(seed)
        return RequestBatch.from_arrays(times, prompts, outputs)


def replay(times: Sequence[float], prompts: Sequence[int] | int = 0,
           outputs: Sequence[int] | int = 1) -> list[Request]:
    """Requests from an explicit arrival-time trace (replayed workload)."""
    n = len(times)
    p = [prompts] * n if isinstance(prompts, int) else list(prompts)
    o = [outputs] * n if isinstance(outputs, int) else list(outputs)
    order = np.argsort(np.asarray(times, dtype=float), kind="stable")
    return [Request(rid=int(i), t_arrival=float(times[i]),
                    prompt_tokens=int(p[i]), output_tokens=int(o[i]))
            for i in order]


# -- struct-of-arrays requests -------------------------------------------------

@dataclass
class RequestBatch:
    """A request stream as struct-of-arrays — rows are requests, sorted by
    ``(t_arrival, rid)`` exactly like :func:`fresh_requests` orders object
    lists. The batched fleet core (``repro_torch.serve.fleetbatch``) reads the
    static columns and fills the timing columns in place; :meth:`fresh`
    hands out a pristine copy so one generated stream can drive every probe
    of a fleet-size scan arrival-identically."""

    rid: np.ndarray             # int64
    t_arrival: np.ndarray       # float64, ascending (rid tie-break)
    prompt_tokens: np.ndarray   # int64
    output_tokens: np.ndarray   # int64
    # -- filled in by the simulator -------------------------------------------
    t_admitted: np.ndarray = None
    t_first_token: np.ndarray = None
    t_done: np.ndarray = None
    tokens_emitted: np.ndarray = None
    evictions: np.ndarray = None

    def __post_init__(self):
        n = len(self.rid)
        if self.t_admitted is None:
            self.t_admitted = np.full(n, NAN)
        if self.t_first_token is None:
            self.t_first_token = np.full(n, NAN)
        if self.t_done is None:
            self.t_done = np.full(n, NAN)
        if self.tokens_emitted is None:
            self.tokens_emitted = np.zeros(n, dtype=np.int64)
        if self.evictions is None:
            self.evictions = np.zeros(n, dtype=np.int64)
        if np.any(self.output_tokens < 1):
            raise ValueError("output_tokens must be >= 1")
        if np.any(self.prompt_tokens < 0) or np.any(self.t_arrival < 0):
            raise ValueError("prompt_tokens/t_arrival must be >= 0")

    def __len__(self) -> int:
        return len(self.rid)

    @property
    def kv_tokens(self) -> np.ndarray:
        """Peak KV residency each request reserves at admission."""
        return self.prompt_tokens + self.output_tokens

    @classmethod
    def from_arrays(cls, times, prompts, outputs,
                    rids=None) -> "RequestBatch":
        t = np.asarray(times, dtype=np.float64)
        rid = np.arange(len(t), dtype=np.int64) if rids is None \
            else np.asarray(rids, dtype=np.int64)
        order = np.lexsort((rid, t))
        return cls(rid=rid[order], t_arrival=t[order],
                   prompt_tokens=np.asarray(prompts, np.int64)[order],
                   output_tokens=np.asarray(outputs, np.int64)[order])

    @classmethod
    def from_requests(cls, requests: Iterable[Request]) -> "RequestBatch":
        reqs = list(requests)
        return cls.from_arrays([r.t_arrival for r in reqs],
                               [r.prompt_tokens for r in reqs],
                               [r.output_tokens for r in reqs],
                               rids=[r.rid for r in reqs])

    @classmethod
    def from_completed(cls, reqs: Sequence[Request]) -> "RequestBatch":
        """SoA snapshot of an already-simulated request list. ``reqs`` must
        be arrival-sorted (:func:`fresh_requests` order), so columns line up
        positionally."""
        rb = cls.from_requests(reqs)
        rb.t_admitted = np.array([r.t_admitted for r in reqs])
        rb.t_first_token = np.array([r.t_first_token for r in reqs])
        rb.t_done = np.array([r.t_done for r in reqs])
        rb.tokens_emitted = np.array([r.tokens_emitted for r in reqs],
                                     dtype=np.int64)
        rb.evictions = np.array([r.evictions for r in reqs], dtype=np.int64)
        return rb

    def fresh(self) -> "RequestBatch":
        """Pristine copy (timing columns reset) — the SoA analogue of
        :func:`fresh_requests`."""
        return RequestBatch(rid=self.rid, t_arrival=self.t_arrival,
                            prompt_tokens=self.prompt_tokens,
                            output_tokens=self.output_tokens)

    def to_requests(self) -> list[Request]:
        """Materialize per-request objects (compat with the oracle API)."""
        out = []
        for i in range(len(self.rid)):
            r = Request(rid=int(self.rid[i]),
                        t_arrival=float(self.t_arrival[i]),
                        prompt_tokens=int(self.prompt_tokens[i]),
                        output_tokens=int(self.output_tokens[i]))
            r.t_admitted = float(self.t_admitted[i])
            r.t_first_token = float(self.t_first_token[i])
            r.t_done = float(self.t_done[i])
            r.tokens_emitted = int(self.tokens_emitted[i])
            r.evictions = int(self.evictions[i])
            out.append(r)
        return out


# -- instance mechanics --------------------------------------------------------

@dataclass(frozen=True)
class ObsConfig:
    """Observability level threaded through the serving engines.

    * level 0 (default): engines record the base 7-column :class:`StepLog`.
    * level 1: each step-log row carries one extra column,
      ``prefill_tokens`` — the prompt-chunk tokens the iteration consumed —
      which is what ``repro_torch.obs.timeline`` needs to split instance lanes
      into prefill-heavy vs pure-decode spans.

    Every level produces bit-identical timing results (parity-asserted both
    ways in tests): the column is derived from values the schedulers already
    compute, never from extra work on the hot path.
    """

    level: int = 0

    def __post_init__(self):
        if self.level not in (0, 1):
            raise ValueError(f"ObsConfig.level must be 0 or 1, "
                             f"got {self.level!r}")

    @property
    def step_phases(self) -> bool:
        """Whether step logs carry the ``prefill_tokens`` column."""
        return self.level >= 1


def _obs_phases(obs: ObsConfig | None) -> bool:
    return obs is not None and obs.step_phases


@dataclass
class StepLog:
    """Per-iteration schedule record (numpy views over the run).

    ``kv_reserved`` is the committed KV footprint in token units (paged:
    committed pages x page_size); ``pages`` is the mapped-page demand of
    the iteration (0 under full reservation, which maps nothing).
    ``prefill_tokens`` (prompt-chunk tokens consumed by the iteration) is
    only recorded at ``ObsConfig(level=1)`` and is ``None`` otherwise."""

    t_start: np.ndarray
    t_end: np.ndarray
    batch: np.ndarray
    kv_reserved: np.ndarray
    queued: np.ndarray       # waiting-queue depth after admission
    admitted: np.ndarray
    pages: np.ndarray        # mapped KV pages during the iteration
    prefill_tokens: np.ndarray | None = None   # ObsConfig(level>=1) only

    @classmethod
    def from_rows(cls, rows: list[tuple]) -> "StepLog":
        if not rows:
            cols = np.empty((7, 0), dtype=float)
        else:
            # zip(*rows) transposes at C speed — much faster than
            # np.array() introspecting a list of tuples row by row
            cols = [np.asarray(c, dtype=float) for c in zip(*rows)]
        return cls(t_start=cols[0], t_end=cols[1],
                   batch=cols[2].astype(int), kv_reserved=cols[3],
                   queued=cols[4].astype(int), admitted=cols[5].astype(int),
                   pages=cols[6].astype(int),
                   prefill_tokens=(cols[7].astype(int) if len(cols) > 7
                                   else None))


class Instance:
    """One serving instance: FIFO admission into a continuous batch.

    The event loop (here or in ``repro_torch.serve.fleet``) drives it with
    ``submit`` at arrival events and ``finish_step`` at step completions;
    ``start_step`` returns the completion time to schedule (or None when
    idle). ``load`` is what routers and the autoscaler observe.

    KV residency goes through a ``repro_torch.serve.paged`` allocator: the
    default is the scalar full-reservation :class:`~repro_torch.serve.paged.
    ReservedKv` (the pre-paging behavior, bit-for-bit); a
    :class:`~repro_torch.serve.paged.PagedKvSpec` swaps in the block-table
    :class:`~repro_torch.serve.paged.PagedKv`. A :class:`~repro_torch.serve.paged.
    SchedPolicy` selects chunked-prefill / decode-priority scheduling on
    the same hook. Each iteration is planned at ``start_step`` as
    ``(request, prompt chunk consumed, emits-a-token)`` triples; the plan
    is replayed by ``finish_step`` so both phases agree on what the
    iteration did."""

    def __init__(self, cost, max_batch: int | None = None,
                 kv_capacity_tokens: float = float("inf"),
                 paged: PagedKvSpec | None = None,
                 sched: SchedPolicy | None = None,
                 obs: ObsConfig | None = None):
        self.cost = cost
        self.max_batch = int(max_batch if max_batch is not None
                             else cost.max_batch)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.kv_capacity_tokens = float(kv_capacity_tokens)
        self.paged = paged
        self.sched = sched if sched is not None else SchedPolicy()
        self.alloc = make_allocator(self.kv_capacity_tokens, paged)
        self._obs_phases = _obs_phases(obs)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.busy = False
        self._plan: list[tuple[Request, int, bool]] = []
        self._log_rows: list[tuple] = []

    @property
    def kv_reserved(self) -> float:
        """Committed KV footprint in token units (allocator-backed)."""
        return self.alloc.committed_tokens

    @property
    def load(self) -> int:
        return len(self.waiting) + len(self.running)

    @property
    def idle(self) -> bool:
        return not self.busy and self.load == 0

    def submit(self, req: Request) -> None:
        if not self.alloc.fits(req.kv_tokens):
            if self.paged is None:
                raise ValueError(
                    f"request {req.rid} needs {req.kv_tokens} KV tokens; "
                    f"instance capacity is {self.kv_capacity_tokens:.0f} — "
                    f"it can never be admitted")
            raise ValueError(
                f"request {req.rid} needs "
                f"{self.alloc.pages_for(req.kv_tokens)} KV pages; instance "
                f"capacity is {self.alloc.capacity_pages} — it can never "
                f"be admitted")
        self.waiting.append(req)

    def start_step(self, now: float) -> float | None:
        """Evict (paged, over-pressure) + admit + begin one iteration;
        returns its completion time, or None when there is nothing to
        run."""
        if self.busy:
            raise RuntimeError("instance already mid-step")
        paged = self.alloc.page_size is not None
        chunk_cap = self.sched.prefill_chunk
        # -- plan the iteration for the carried-over running batch ------------
        plan: list[tuple[Request, int, bool]] = []
        demands: list[int] = []
        demand = 0
        for r in self.running:
            rem = r._ctx - r._consumed
            chunk = 0 if rem <= 0 else \
                (rem if chunk_cap is None or chunk_cap >= rem else chunk_cap)
            emits = chunk >= rem
            plan.append((r, chunk, emits))
            if paged:
                d = self.alloc.pages_for(r._consumed + chunk + r._res_em)
                demands.append(d)
                demand += d
        # -- evict LRU (least-recently-admitted) under page pressure ----------
        if paged and demand > self.alloc.capacity_pages:
            victims: list[Request] = []
            while demand > self.alloc.capacity_pages:
                r, _, _ = plan.pop(0)
                self.running.pop(0)
                demand -= demands.pop(0)
                self.alloc.release(r.rid)
                r.evictions += 1
                victims.append(r)
            # back to the FRONT of the queue, mutual order preserved; their
            # KV (prompt + emitted so far) is recomputed at re-admission
            self.waiting.extendleft(reversed(victims))
        # -- FIFO admission ---------------------------------------------------
        admitted = 0
        mid_prefill = any(not emits for _, _, emits in plan)
        while self.waiting and len(self.running) < self.max_batch:
            if self.sched.decode_priority and self.running \
                    and (mid_prefill or admitted):
                break
            req = self.waiting[0]
            if not self.alloc.can_admit(req.kv_tokens):
                break  # FIFO: no skipping past the blocked head
            base = req.prompt_tokens + req.tokens_emitted
            chunk = base if chunk_cap is None or chunk_cap >= base \
                else chunk_cap
            emits = chunk >= base
            if paged:
                d = self.alloc.pages_for(chunk)
                if demand + d > self.alloc.capacity_pages:
                    break  # admission must never trigger eviction
                demands.append(d)
                demand += d
            self.waiting.popleft()
            if math.isnan(req.t_admitted):
                req.t_admitted = now
            req._ctx = base
            req._consumed = 0
            req._res_em = 0
            self.alloc.admit(req.rid, req.kv_tokens)
            self.running.append(req)
            plan.append((req, chunk, emits))
            admitted += 1
        if not self.running:
            return None
        # -- map pages + price the iteration ----------------------------------
        prefill = 0.0
        resident = 0
        ptoks = 0
        for idx, (r, chunk, _) in enumerate(plan):
            if paged:
                self.alloc.ensure(r.rid, demands[idx])
            else:
                resident += r._consumed + chunk + r._res_em
            if chunk:
                ptoks += chunk
                prefill += self.cost.prefill_time(chunk)
        if paged:
            # priced at page granularity: mapped pages x page_size tokens
            resident = demand * self.alloc.page_size
        dt = self.cost.step_time(len(self.running), resident) + prefill
        if not (dt > 0 and math.isfinite(dt)):
            raise ValueError(f"non-positive/non-finite step time {dt!r}")
        t_end = now + dt
        row = (now, t_end, len(self.running), self.alloc.committed_tokens,
               len(self.waiting), admitted, float(demand))
        self._log_rows.append(row + (ptoks,) if self._obs_phases else row)
        self._plan = plan
        self.busy = True
        return t_end

    def finish_step(self, now: float) -> list[Request]:
        """Replay the iteration's plan: advance prefill progress, emit one
        token per decoding request, complete + release finished ones.
        Returns the completions."""
        if not self.busy:
            raise RuntimeError("no step in flight")
        self.busy = False
        done: list[Request] = []
        still: list[Request] = []
        for r, chunk, emits in self._plan:
            r._consumed += chunk
            if emits:
                r.tokens_emitted += 1
                r._res_em += 1
                if r.tokens_emitted == 1:
                    r.t_first_token = now
                if r.tokens_emitted >= r.output_tokens:
                    r.t_done = now
                    self.alloc.release(r.rid, r.kv_tokens)
                    done.append(r)
                    continue
            still.append(r)
        self.running = still
        self._plan = []
        return done

    def step_log(self) -> StepLog:
        return StepLog.from_rows(self._log_rows)


# -- metrics / SLO -------------------------------------------------------------

@dataclass(frozen=True)
class Slo:
    """A latency SLO: the ``percentile`` of each finite target must be met.
    Per-request, TPOT is ignored for single-token requests (no inter-token
    gap exists)."""

    ttft_s: float = float("inf")
    tpot_s: float = float("inf")
    e2e_s: float = float("inf")
    percentile: float = 99.0

    def met(self, m: "SimMetrics") -> bool:
        if len(m.ttft) == 0:
            return True
        p = self.percentile
        # TPOT percentile over multi-token requests ONLY — single-token
        # requests have no inter-token gap (tpot recorded as 0.0) and would
        # dilute the percentile, under-sizing fleets on short-output
        # workloads (and agreeing with ``ok_mask``, which exempts them too).
        tpot = m.tpot[m.output_tokens > 1]
        tpot_ok = len(tpot) == 0 or np.percentile(tpot, p) <= self.tpot_s
        return (np.percentile(m.ttft, p) <= self.ttft_s
                and tpot_ok
                and np.percentile(m.e2e, p) <= self.e2e_s)

    def ok_mask(self, m: "SimMetrics") -> np.ndarray:
        multi = m.output_tokens > 1
        return ((m.ttft <= self.ttft_s)
                & (np.where(multi, m.tpot, 0.0) <= self.tpot_s)
                & (m.e2e <= self.e2e_s))


@dataclass
class SimMetrics:
    """Vectorized per-request timings for one simulation."""

    ttft: np.ndarray
    tpot: np.ndarray            # 0 for single-token requests
    e2e: np.ndarray
    output_tokens: np.ndarray
    t_first_arrival: float
    t_last_done: float
    evictions: np.ndarray = None   # per-request paged-KV recompute count

    def __post_init__(self):
        if self.evictions is None:
            self.evictions = np.zeros(len(self.ttft), dtype=np.int64)

    @classmethod
    def from_arrays(cls, t_arr, t_first, t_done, out,
                    evictions=None) -> "SimMetrics":
        """Metrics straight from timing columns (a :class:`RequestBatch`) —
        no per-request objects in the loop."""
        if len(t_arr) == 0:
            z = np.zeros(0)
            return cls(z, z, z, z.astype(int), 0.0, 0.0)
        t_arr, t_first, t_done, out = (np.asarray(t_arr, dtype=np.float64),
                                       np.asarray(t_first, dtype=np.float64),
                                       np.asarray(t_done, dtype=np.float64),
                                       np.asarray(out, dtype=np.float64))
        if np.isnan(t_done).any():
            raise ValueError("metrics over an incomplete simulation")
        gaps = np.maximum(out - 1, 1)
        return cls(
            ttft=t_first - t_arr,
            tpot=np.where(out > 1, (t_done - t_first) / gaps, 0.0),
            e2e=t_done - t_arr,
            output_tokens=out.astype(int),
            t_first_arrival=float(t_arr.min()),
            t_last_done=float(t_done.max()),
            evictions=(None if evictions is None
                       else np.asarray(evictions, dtype=np.int64)),
        )

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "SimMetrics":
        if not requests:
            z = np.zeros(0)
            return cls(z, z, z, z.astype(int), 0.0, 0.0)
        arr = np.array([(r.t_arrival, r.t_first_token, r.t_done,
                         r.output_tokens) for r in requests])
        t_arr, t_first, t_done, out = arr.T
        return cls.from_arrays(t_arr, t_first, t_done, out,
                               evictions=[r.evictions for r in requests])

    @classmethod
    def from_batch(cls, batch: "RequestBatch") -> "SimMetrics":
        return cls.from_arrays(batch.t_arrival, batch.t_first_token,
                               batch.t_done, batch.output_tokens,
                               evictions=batch.evictions)

    @property
    def makespan_s(self) -> float:
        return max(self.t_last_done - self.t_first_arrival, 1e-12)

    @property
    def total_evictions(self) -> int:
        """Paged-KV evictions (KV recomputes) across all requests."""
        return int(self.evictions.sum())

    @property
    def eviction_rate_rps(self) -> float:
        """Evictions per second of makespan."""
        return self.total_evictions / self.makespan_s

    @property
    def evicted_frac(self) -> float:
        """Fraction of requests evicted at least once."""
        if len(self.evictions) == 0:
            return 0.0
        return float((self.evictions > 0).mean())

    @property
    def throughput_rps(self) -> float:
        return len(self.ttft) / self.makespan_s

    @property
    def throughput_tokens(self) -> float:
        return float(self.output_tokens.sum()) / self.makespan_s

    def percentile(self, metric: str, p: float) -> float:
        xs = getattr(self, metric)
        return float(np.percentile(xs, p)) if len(xs) else 0.0

    def goodput_rps(self, slo: Slo) -> float:
        """SLO-constrained goodput: requests/s whose individual TTFT/TPOT/E2E
        all met the targets."""
        if len(self.ttft) == 0:
            return 0.0
        return float(slo.ok_mask(self).sum()) / self.makespan_s


@dataclass
class SimResult:
    requests: list[Request]
    metrics: SimMetrics
    step_log: StepLog


# -- the single-instance event loop --------------------------------------------

_ARRIVAL, _STEP_DONE = 0, 1


def fresh_requests(requests: Iterable[Request]) -> list[Request]:
    """Pristine copies of a request list, arrival-sorted. Simulations fill
    timing state into their requests, so a shared list (a replayed trace
    scanned over several fleet sizes) must be re-materialized per run —
    without this, run 2 would see run 1's tokens as already emitted."""
    return sorted((replace(r, t_admitted=NAN, t_first_token=NAN, t_done=NAN,
                           tokens_emitted=0, evictions=0) for r in requests),
                  key=lambda r: (r.t_arrival, r.rid))


def simulate(requests: Iterable[Request], cost, *,
             max_batch: int | None = None,
             kv_capacity_tokens: float = float("inf"),
             paged: PagedKvSpec | None = None,
             sched: SchedPolicy | None = None,
             obs: ObsConfig | None = None) -> SimResult:
    """Run one instance over an open-loop arrival stream to completion.

    A heap-ordered discrete-event loop: arrival events enqueue into the
    instance; step-completion events emit tokens and immediately start the
    next iteration while work remains. Deterministic given the request list
    (which is copied, so one list can drive many runs). ``paged``/``sched``
    select the KV residency and scheduling policies (see
    ``repro_torch.serve.paged``); the defaults preserve the full-reservation
    behavior exactly.
    """
    reqs = fresh_requests(requests)
    inst = Instance(cost, max_batch=max_batch,
                    kv_capacity_tokens=kv_capacity_tokens,
                    paged=paged, sched=sched, obs=obs)
    events: list[tuple[float, int, int]] = []  # (time, seq, kind)
    seq = 0
    for r in reqs:
        heapq.heappush(events, (r.t_arrival, seq, _ARRIVAL))
        seq += 1
    next_arrival = 0  # index into reqs, in heap-push order
    clock = 0.0
    while events:
        t, _, kind = heapq.heappop(events)
        assert t >= clock, "simulation clock went backwards"
        clock = t
        # Drain EVERY event at this timestamp before starting an iteration:
        # simultaneous arrivals must all be admissible into the same batch
        # (saturation at arrival-rate -> inf fills whole batches).
        while True:
            if kind == _ARRIVAL:
                inst.submit(reqs[next_arrival])
                next_arrival += 1
            else:
                inst.finish_step(t)
            if not (events and events[0][0] == t):
                break
            _, _, kind = heapq.heappop(events)
        if not inst.busy:
            t_end = inst.start_step(t)
            if t_end is not None:
                heapq.heappush(events, (t_end, seq, _STEP_DONE))
                seq += 1
    assert not inst.waiting and not inst.running, "requests left in system"
    return SimResult(requests=reqs,
                     metrics=SimMetrics.from_requests(reqs),
                     step_log=inst.step_log())


def _reference_sim(req: Request, cost) -> tuple[float, float]:
    """Closed-form (t_first_token, t_done) for ONE request on an idle
    instance — the oracle the event loop must reproduce exactly.

    The request is admitted at arrival; iteration k (0-based) runs at batch 1
    with ``prompt + k`` resident tokens; the first iteration also pays the
    prefill."""
    t = req.t_arrival + cost.prefill_time(req.prompt_tokens)
    t_first = NAN
    for k in range(req.output_tokens):
        t += cost.step_time(1, req.prompt_tokens + k)
        if k == 0:
            t_first = t
    return t_first, t
