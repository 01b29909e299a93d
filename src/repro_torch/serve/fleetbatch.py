"""Vectorized fleet core: the whole fleet as struct-of-arrays event state.

``repro_torch.serve.fleet.FleetSim`` answers the paper's scale-out question at the
request level, but its per-instance loop walks Python ``Request`` objects —
O(batch) attribute churn per engine iteration — which caps it at tens of
instances. This module re-runs the SAME discrete-event semantics with fleet
state as arrays (the batched-scan-over-rows move ``StreamBatch`` made for
traces): requests are the columns of a :class:`~repro_torch.serve.sim.RequestBatch`
and instances are rows of scalar event state, so a 500-instance
100k-request diurnal run prices in seconds instead of minutes.

What makes it fast — and still bit-identical to the oracle:

* **Arrivals are a sorted array + pointer, not heap entries.** Only step
  completions and autoscale ticks live in the heap; arrival events always
  outrank same-timestamp heap events (their sequence numbers are smaller,
  exactly as the oracle pushes them), so wave ordering is preserved.
* **O(1) step state via admission-step aggregates.** A request admitted at
  instance step ``k`` has emitted ``step - k`` tokens ever after, so the
  resident-KV sum the cost model needs is the closed form
  ``sum_prompt + batch * step - sum_admit_step`` — three counters updated
  only at admission/completion, never a per-request sweep per iteration.
* **Completions are pre-bucketed by step index.** Admission at step ``k``
  of a request with ``o`` output tokens schedules its completion at step
  ``k + o - 1``; each step-finish pops one bucket (ids + aggregate sums)
  instead of scanning the running batch.
* **Waves batch the pricing.** All events at one timestamp drain first
  (simultaneous arrivals share batches, as in the oracle); every instance
  the wave kicked then prices its next iteration through ONE vectorized
  :meth:`~repro_torch.core.sweep.CostGrid.step_time` call, with a bisect-based
  scalar fast path when the wave touched a single instance.
* **FIFO admission uses a vectorized prefix check over the commit budget**
  — a cumulative-sum + ``searchsorted`` over the waiting head region (KV
  tokens under full reservation, committed pages under paged KV) — when
  the candidate window is wide, and an amortized-O(1) scalar walk
  otherwise.
* **Paged KV occupancy is O(1) per step via page-crossing buckets.** A
  request admitted at step ``k`` with ``prompt`` context maps a new page
  exactly at the steps ``s > k`` with ``s ≡ k + 1 - prompt (mod
  page_size)``, so one ``page_size``-slot increment array per instance
  (plus per-completion-bucket removal lists) carries the mapped-page sum
  the pricing and the step log need — no per-request page walk.

Two cores share this file. The fast path above covers full reservation and
paged KV with ``oversubscription <= 1`` under default scheduling — the
regimes where admission order fully determines residency. Eviction,
chunked prefill and decode-priority break the O(1) aggregates (occupancy
stops being a pure function of admission step), so those dispatch to
:func:`_run_fleet_rich`: the same event skeleton with O(batch) per-step
state transitions over int-list residency columns — still array-backed
and allocation-free, and still bit-identical to the oracle.

``repro_torch.serve.fleet.FleetSim.run`` dispatches here by default; the
per-instance ``Instance``/heap loop survives behind ``run(batched=False)``
as the parity oracle, asserted request-for-request bit-identical (timings,
step logs, scale events) in ``tests/test_fleet_batch.py`` and
``tests/test_paged_kv.py``.
"""
from __future__ import annotations

import heapq
import math
from bisect import bisect_left
from collections import deque

import numpy as np

from repro_torch.serve.paged import PagedKvSpec, SchedPolicy
from repro_torch.serve.sim import ObsConfig, RequestBatch, SimMetrics, StepLog
from repro_torch.serve.sim import _obs_phases as _obs_on

# Below this many candidates/completions the scalar path beats numpy-call
# overhead; both paths are exact, so the cutover is pure perf.
_VEC_CUTOVER = 8


def _scalar_pricer(cost):
    """(step_time, prefill_time, grid_like, per_tok) with a pure-Python
    bisect fast path for ``CostGrid``-shaped costs — identical table
    lookups, no per-step numpy call overhead. ``per_tok`` is the grid's
    prefill seconds/token (None for non-grid costs), so hot loops can
    inline the multiply instead of calling ``prefill_time``."""
    grid_like = (hasattr(cost, "step_time_s") and hasattr(cost, "batches")
                 and hasattr(cost, "seq_edges"))
    if not grid_like:
        return cost.step_time, cost.prefill_time, False, None
    batches = list(cost.batches)
    edges = list(cost.seq_edges)
    table = np.asarray(cost.step_time_s).tolist()   # exact float64 values
    max_b, last_j = batches[-1], len(edges) - 1

    def step_time(batch, resident):
        if batch < 1 or batch > max_b:
            raise ValueError(
                f"batch outside priced range [1, {max_b}]: {batch!r}")
        j = bisect_left(edges, resident)
        return table[bisect_left(batches, batch)][
            j if j < last_j else last_j]

    per_tok = float(getattr(cost, "prefill_s_per_token", 0.0))

    def prefill_time(prompt_tokens):
        return prompt_tokens * per_tok

    return step_time, prefill_time, True, per_tok


def run_fleet(cost, batch: RequestBatch, *, n_instances: int = 1,
              router: str = "least_loaded", max_batch: int | None = None,
              kv_capacity_tokens: float = float("inf"),
              paged: PagedKvSpec | None = None,
              sched: SchedPolicy | None = None,
              autoscaler=None, autoscale_interval_s: float = 0.0,
              obs: ObsConfig | None = None):
    """One batched fleet run over ``batch`` (consumed via a fresh copy).

    Semantics are exactly ``FleetSim.run(batched=False)``; see the module
    docstring for the vectorization strategy and the fast/rich dispatch.
    Returns a :class:`~repro_torch.serve.fleet.FleetResult`.
    """
    from repro_torch.serve.fleet import ROUTERS, FleetResult, ScaleEvent

    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r}; one of {ROUTERS}")
    if n_instances < 1:
        raise ValueError("n_instances must be >= 1")
    if autoscaler is not None and autoscale_interval_s <= 0:
        raise ValueError("autoscaler needs autoscale_interval_s > 0")
    mb = int(max_batch if max_batch is not None else cost.max_batch)
    if mb < 1:
        raise ValueError("max_batch must be >= 1")
    cap = float(kv_capacity_tokens)
    interval = float(autoscale_interval_s)
    if sched is None:
        sched = SchedPolicy()
    # Eviction / chunked prefill / decode-priority make page occupancy
    # history-dependent — the O(1) aggregates below no longer apply, so
    # those policies run on the rich per-request core instead.
    if not sched.is_default or (paged is not None
                                and paged.oversubscription > 1.0):
        return _run_fleet_rich(cost, batch, n_instances=n_instances,
                               router=router, mb=mb, cap=cap, paged=paged,
                               sched=sched, autoscaler=autoscaler,
                               interval=interval, obs=obs)
    round_robin = router == "round_robin"
    # ObsConfig level 1: step-log rows carry an 8th column (prefill tokens
    # consumed by the iteration) — a value the admission loops already sum,
    # so the extra work is one tuple concat per logged step.
    OBS = _obs_on(obs)

    b = batch.fresh()
    n = len(b)
    t_admitted, t_first, t_done = b.t_admitted, b.t_first_token, b.t_done
    tokens_emitted = b.tokens_emitted
    outputs = b.output_tokens
    # python lists: ~30ns scalar reads in the hot loop vs numpy item access
    t_arr_l = b.t_arrival.tolist()
    rid_l = b.rid.tolist()
    prompt_l = b.prompt_tokens.tolist()
    out_l = outputs.tolist()
    kv_arr = b.kv_tokens
    kv_l = kv_arr.tolist()

    # Paged fast path (oversubscription <= 1, default scheduling): commit
    # accounting runs in page units against the oversubscribable budget;
    # mapped-page occupancy is carried by O(1) crossing buckets (see the
    # module docstring). ``cu_*`` are the commit units the admission
    # prefix check sums — KV tokens under reservation, peak pages when
    # paged — so one code path serves both.
    PF = paged is not None
    if PF:
        P = paged.page_size
        cap_pages = float("inf") if math.isinf(cap) else int(cap // P)
        budget = cap_pages * paged.oversubscription
        cu_l = [(kv + P - 1) // P for kv in kv_l]
        cu_arr = np.asarray(cu_l, dtype=np.int64)
        fit_limit = cap_pages
    else:
        P = 1
        budget = cap
        cu_l = kv_l
        cu_arr = kv_arr
        fit_limit = cap

    def _never_admissible(row: int) -> ValueError:
        if PF:
            return ValueError(
                f"request {rid_l[row]} needs {cu_l[row]} KV pages; "
                f"instance capacity is {cap_pages} — it can never be "
                f"admitted")
        return ValueError(
            f"request {rid_l[row]} needs {kv_l[row]} KV tokens; "
            f"instance capacity is {cap:.0f} — it can never be "
            f"admitted")

    step_scalar, prefill_scalar, grid_like, per_tok = _scalar_pricer(cost)
    if grid_like:      # hot loops inline the table lookup (no call overhead)
        g_batches = list(cost.batches)
        g_edges = list(cost.seq_edges)
        g_table = np.asarray(cost.step_time_s).tolist()
        g_maxb, g_lastj = g_batches[-1], len(g_edges) - 1
        # validate once so grid-priced steps skip the per-step dt check
        # (a grid cell + non-negative finite prefill is always a valid dt)
        for row_ in g_table:
            for v in row_:
                if not (v > 0 and math.isfinite(v)):
                    raise ValueError(
                        f"non-positive/non-finite step time {v!r}")
        if not (per_tok >= 0 and math.isfinite(per_tok)):
            raise ValueError(
                f"non-finite/negative prefill_s_per_token {per_tok!r}")
        # direct batch-size -> table-row map (batch rounds UP to the next
        # priced size) so the per-step lookup is one list index + one bisect
        g_row = [None] + [g_table[bisect_left(g_batches, bb)]
                          for bb in range(1, g_maxb + 1)]

    # -- per-instance event state (index = instance id, rows of the fleet) -----
    busy: list[bool] = []
    kvres: list = []                 # committed units (KV tokens / pages)
    nrun: list[int] = []             # running batch size
    sum_p: list[int] = []            # sum of running prompts
    sum_as: list[int] = []           # sum of running admission step indices
    kstep: list[int] = []            # steps started
    wait_q: list[list[int]] = []     # FIFO waiting rows...
    wait_h: list[int] = []           # ...consumed from a head pointer
    # finish step -> [rows, cnt, Σp, Σk, Σcu, Σd_last, crossing slots]
    buckets: list[dict[int, list]] = []
    logs: list[list[tuple]] = []
    load: list[int] = []                 # waiting + running, per instance id
    mapped: list[int] = []           # paged: mapped pages this step
    pinc: list[list[int]] = []       # paged: page crossings per step mod P

    active: list[int] = []
    draining: list[int] = []
    draining_set: set[int] = set()
    retire_records: list[tuple[float, int]] = []   # (t_retired, instance)
    # routing state: loads of ACTIVE instances, compact and position-aligned
    # with `active` so least-loaded is one argmin (no fancy indexing);
    # posl[i] is instance i's position in `active` (-1 when not active)
    load_act = np.zeros(0, dtype=np.int64)
    posl: list[int] = []

    def rebuild_active() -> None:
        nonlocal load_act
        load_act = np.asarray([load[i] for i in active], dtype=np.int64)
        for idx in range(len(posl)):
            posl[idx] = -1
        for p, i in enumerate(active):
            posl[i] = p

    def spawn() -> None:
        i = len(busy)
        busy.append(False); kvres.append(0 if PF else 0.0); nrun.append(0)
        sum_p.append(0); sum_as.append(0); kstep.append(0)
        wait_q.append([]); wait_h.append(0)
        buckets.append({}); logs.append([])
        load.append(0)
        mapped.append(0); pinc.append([0] * P if PF else None)
        posl.append(-1)
        active.append(i)

    def drain_one(now: float) -> None:
        if len(active) <= 1:
            return
        i = active.pop(int(load_act.argmin()))
        rebuild_active()
        if not busy[i] and load[i] == 0:
            retire_records.append((now, i))
        else:
            draining.append(i)
            draining_set.add(i)

    for _ in range(n_instances):
        spawn()
    rebuild_active()

    def admit(i: int, now: float) -> tuple[list[int], float, int]:
        """FIFO admission bounded by batch slots and the committed-unit
        prefix (no skipping past a blocked head) — the oracle's admission
        loop. Returns (admitted rows, their summed prefill time, their
        summed prompt tokens — the fast path prefills whole prompts at
        admission, so that sum IS the iteration's prefill-token count)."""
        h, w = wait_h[i], wait_q[i]
        lim = len(w) - h
        slots = mb - nrun[i]
        if slots < lim:
            lim = slots
        if lim <= 0:
            return (), 0.0, 0
        cap_left = budget - kvres[i]
        if lim <= _VEC_CUTOVER:
            m, acc = 0, 0
            while m < lim:
                cu = cu_l[w[h + m]]
                if acc + cu > cap_left:
                    break
                acc += cu
                m += 1
        else:
            # vectorized prefix check: largest m with cumsum(cu) <= budget
            csum = np.cumsum(cu_arr[w[h:h + lim]])
            m = int(np.searchsorted(csum, cap_left, side="right"))
        if m == 0:
            return (), 0.0, 0
        rows = w[h:h + m]
        wait_h[i] = h + m
        if h + m > 512 and (h + m) * 2 >= len(w):
            del w[:h + m]
            wait_h[i] = 0
        if m <= _VEC_CUTOVER:
            for r in rows:
                t_admitted[r] = now
        else:
            t_admitted[rows] = now
        k = kstep[i]
        tot_cu = tot_p = 0
        prefill = 0.0
        bks = buckets[i]
        if PF:
            mp_i = mapped[i]
            pinc_i = pinc[i]
        for r in rows:
            fk = k + out_l[r] - 1          # the step whose end completes r
            bkt = bks.get(fk)
            if bkt is None:
                bks[fk] = bkt = [[], 0, 0, 0, 0, 0, []]
            bkt[0].append(r)
            bkt[1] += 1
            p = prompt_l[r]
            bkt[2] += p
            bkt[3] += k
            bkt[4] += cu_l[r]
            tot_cu += cu_l[r]
            tot_p += p
            if PF:
                # first-step demand: the prompt being prefilled this step
                mp_i += (p + P - 1) // P
                jr = (k + 1 - p) % P       # page-crossing residue class
                pinc_i[jr] += 1
                bkt[5] += (p + out_l[r] - 1 + P - 1) // P   # d_last
                bkt[6].append(jr)
            # oracle order: per-request prefill times summed left-to-right
            prefill += p * per_tok if per_tok is not None \
                else prefill_scalar(p)
        if PF:
            mapped[i] = mp_i
        kvres[i] += tot_cu
        nrun[i] += m
        sum_p[i] += tot_p
        sum_as[i] += m * k
        return rows, prefill, tot_p

    # -- the global event loop -------------------------------------------------
    # Steps live in the heap as (t_end, seq, instance); arrivals stay a
    # sorted array + pointer and the (single) pending autoscale tick is a
    # scalar. At equal timestamps arrivals outrank everything (seqs 0..n-1,
    # exactly the order the oracle pushed them) and step/tick events
    # interleave by seq — the oracle's heap order.
    INF = float("inf")
    heap: list[tuple[float, int, int]] = []
    seq = n          # arrivals implicitly hold seqs 0..n-1 (array order)
    arr_ptr = 0
    done = 0
    clock = 0.0
    rr = 0
    scale_events: list[ScaleEvent] = []
    tick_pending = False
    next_tick, tick_seq = INF, -1
    if autoscaler is not None and n:
        tick_pending, next_tick, tick_seq = True, t_arr_l[0] + interval, seq
        seq += 1

    while (arr_ptr < n or heap or tick_pending) and done < n:
        Ta = t_arr_l[arr_ptr] if arr_ptr < n else INF
        Tt = next_tick if tick_pending else INF
        T = Ta if Ta <= Tt else Tt
        # Fast-forward: between interaction points (arrivals / autoscale
        # ticks) instances are independent, so run each popped instance's
        # finish->admit->start chain privately until it crosses T or goes
        # idle — no heap churn or wave scaffolding per step. Steps landing
        # exactly ON T stay in the heap for the wave below, preserving the
        # oracle's ordering against same-timestamp arrivals and ticks.
        while heap and heap[0][0] < T:
            tcur, _, i = heapq.heappop(heap)
            # Chain-local scalars (written back after the chain): between
            # interaction points no other instance can observe this state,
            # and the chain was popped busy so ``busy[i]`` stays True
            # unless the instance retires or idles out.
            bks = buckets[i]
            logs_i = logs[i]
            w = wait_q[i]
            k_i = kstep[i]
            nr = nrun[i]
            sp_i = sum_p[i]
            sa_i = sum_as[i]
            kvr = kvres[i]
            h = wait_h[i]
            ld = load[i]
            pp = posl[i]
            mp_i = mapped[i]
            pinc_i = pinc[i]
            drn = i in draining_set
            while True:
                bkt = bks.pop(k_i - 1, None)
                if bkt is not None:
                    rows, cnt, sp, sa, scu, sdl, jl = bkt
                    if cnt <= _VEC_CUTOVER:
                        for r in rows:
                            t_done[r] = tcur
                            tokens_emitted[r] = out_l[r]
                    else:
                        t_done[rows] = tcur
                        tokens_emitted[rows] = outputs[rows]
                    nr -= cnt
                    sp_i -= sp
                    sa_i -= sa
                    kvr -= scu
                    ld -= cnt
                    if pp >= 0:
                        load_act[pp] -= cnt
                    done += cnt
                    if PF:
                        mp_i -= sdl
                        for jr in jl:
                            pinc_i[jr] -= 1
                if drn and ld == 0:
                    draining.remove(i)
                    draining_set.discard(i)
                    retire_records.append((tcur, i))
                    busy[i] = False
                    break
                if PF:
                    # carried-over requests crossing into a new page at
                    # step k_i (admissions below register AFTER this, so
                    # their first-step demand is never double-counted)
                    mp_i += pinc_i[k_i % P]
                # admit(), inlined — this is the engine's hottest block
                lim = len(w) - h
                slots = mb - nr
                if slots < lim:
                    lim = slots
                m = 0
                if lim > 0:
                    cap_left = budget - kvr
                    if lim <= _VEC_CUTOVER:
                        acc = 0
                        while m < lim:
                            cu = cu_l[w[h + m]]
                            if acc + cu > cap_left:
                                break
                            acc += cu
                            m += 1
                    else:
                        csum = np.cumsum(cu_arr[w[h:h + lim]])
                        m = int(np.searchsorted(csum, cap_left,
                                                side="right"))
                prefill = 0.0
                if m:
                    rows = w[h:h + m]
                    h += m
                    if h > 512 and h * 2 >= len(w):
                        del w[:h]
                        h = 0
                    if m <= _VEC_CUTOVER:
                        for r in rows:
                            t_admitted[r] = tcur
                    else:
                        t_admitted[rows] = tcur
                    tot_cu = tot_p = 0
                    for r in rows:
                        fk = k_i + out_l[r] - 1
                        bkt = bks.get(fk)
                        if bkt is None:
                            bks[fk] = bkt = [[], 0, 0, 0, 0, 0, []]
                        bkt[0].append(r)
                        bkt[1] += 1
                        p = prompt_l[r]
                        bkt[2] += p
                        bkt[3] += k_i
                        bkt[4] += cu_l[r]
                        tot_cu += cu_l[r]
                        tot_p += p
                        if PF:
                            mp_i += (p + P - 1) // P
                            jr = (k_i + 1 - p) % P
                            pinc_i[jr] += 1
                            bkt[5] += (p + out_l[r] - 1 + P - 1) // P
                            bkt[6].append(jr)
                        prefill += p * per_tok if per_tok is not None \
                            else prefill_scalar(p)
                    kvr += tot_cu
                    nr += m
                    sp_i += tot_p
                    sa_i += m * k_i
                else:
                    rows = ()
                    tot_p = 0   # no admissions -> no prefill this iteration
                if nr == 0:
                    busy[i] = False
                    break
                resident = mp_i * P if PF else sp_i + nr * k_i - sa_i
                if grid_like:
                    if nr > g_maxb:
                        raise ValueError(
                            f"batch outside priced range [1, {g_maxb}]: "
                            f"{nr!r}")
                    j = bisect_left(g_edges, resident)
                    dt = g_row[nr][j if j < g_lastj else g_lastj] + prefill
                else:
                    dt = step_scalar(nr, resident) + prefill
                    if not (dt > 0 and math.isfinite(dt)):
                        raise ValueError(
                            f"non-positive/non-finite step time {dt!r}")
                t_end = tcur + dt
                if PF:
                    lrow = (tcur, t_end, nr, kvr * P, len(w) - h, m, mp_i)
                else:
                    lrow = (tcur, t_end, nr, kvr, len(w) - h, m, 0.0)
                logs_i.append(lrow + (tot_p,) if OBS else lrow)
                if m:
                    if m <= _VEC_CUTOVER:
                        for r in rows:
                            t_first[r] = t_end
                    else:
                        t_first[rows] = t_end
                k_i += 1
                sq = seq
                seq += 1
                if t_end >= T:
                    heapq.heappush(heap, (t_end, sq, i))
                    break
                tcur = t_end
            kstep[i] = k_i
            nrun[i] = nr
            sum_p[i] = sp_i
            sum_as[i] = sa_i
            kvres[i] = kvr
            wait_h[i] = h
            load[i] = ld
            mapped[i] = mp_i
        if T == INF or done >= n:
            break      # oracle exits before a pending tick once all done
        assert T >= clock, "fleet clock went backwards"
        clock = T
        # Lone arrival (the common wave) — route + submit + start inline.
        if (Ta < Tt and (not heap or heap[0][0] != Ta)
                and (arr_ptr + 1 == n or t_arr_l[arr_ptr + 1] != Ta)):
            row = arr_ptr
            if cu_l[row] > fit_limit:
                raise _never_admissible(row)
            if round_robin:
                i = active[rr % len(active)]
                rr += 1
                p = posl[i]
            elif len(active) == 1:
                i = active[0]
                p = 0
            else:
                p = load_act.argmin()
                i = active[p]
            wait_q[i].append(row)
            load[i] += 1
            load_act[p] += 1
            arr_ptr += 1
            if busy[i]:
                continue
            rows, prefill, ptoks = admit(i, Ta)
            bsz = nrun[i]
            if bsz == 0:
                continue
            resident = mapped[i] * P if PF \
                else sum_p[i] + bsz * kstep[i] - sum_as[i]
            if grid_like:
                if bsz > g_maxb:
                    raise ValueError(
                        f"batch outside priced range [1, {g_maxb}]: {bsz!r}")
                j = bisect_left(g_edges, resident)
                dt = g_row[bsz][j if j < g_lastj else g_lastj] + prefill
            else:
                dt = step_scalar(bsz, resident) + prefill
            if not (dt > 0 and math.isfinite(dt)):
                raise ValueError(f"non-positive/non-finite step time {dt!r}")
            t_end = Ta + dt
            lrow = (Ta, t_end, bsz, kvres[i] * P if PF else kvres[i],
                    len(wait_q[i]) - wait_h[i], len(rows),
                    float(mapped[i]) if PF else 0.0)
            logs[i].append(lrow + (ptoks,) if OBS else lrow)
            if rows:
                # the iteration that prefills a request emits its first token
                if len(rows) <= _VEC_CUTOVER:
                    for r in rows:
                        t_first[r] = t_end
                else:
                    t_first[rows] = t_end
            busy[i] = True
            kstep[i] += 1
            heapq.heappush(heap, (t_end, seq, i))
            seq += 1
            continue
        # General wave at T: drain every same-timestamp event before
        # starting iterations (simultaneous arrivals share a batch — see
        # repro_torch.serve.sim), arrivals first, then steps/ticks by seq.
        kick: dict[int, None] = {}
        while arr_ptr < n and t_arr_l[arr_ptr] == T:
            row = arr_ptr
            if cu_l[row] > fit_limit:
                raise _never_admissible(row)
            if round_robin:
                i = active[rr % len(active)]
                rr += 1
                p = posl[i]
            elif len(active) == 1:
                i = active[0]
                p = 0
            else:
                p = load_act.argmin()
                i = active[p]
            wait_q[i].append(row)
            load[i] += 1
            load_act[p] += 1
            kick[i] = None
            arr_ptr += 1
        while True:
            has_step = bool(heap) and heap[0][0] == T
            has_tick = tick_pending and next_tick == T
            if has_step and (not has_tick or heap[0][1] < tick_seq):
                _, _, i = heapq.heappop(heap)
                busy[i] = False
                bkt = buckets[i].pop(kstep[i] - 1, None)
                if bkt is not None:
                    rows, cnt, sp, sa, scu, sdl, jl = bkt
                    if cnt <= _VEC_CUTOVER:
                        for r in rows:
                            t_done[r] = T
                            tokens_emitted[r] = out_l[r]
                    else:
                        t_done[rows] = T
                        tokens_emitted[rows] = outputs[rows]
                    nrun[i] -= cnt
                    sum_p[i] -= sp
                    sum_as[i] -= sa
                    kvres[i] -= scu
                    load[i] -= cnt
                    if PF:
                        mapped[i] -= sdl
                        pinc_i = pinc[i]
                        for jr in jl:
                            pinc_i[jr] -= 1
                    p = posl[i]
                    if p >= 0:
                        load_act[p] -= cnt
                    done += cnt
                if i in draining_set and load[i] == 0:
                    draining.remove(i)
                    draining_set.discard(i)
                    retire_records.append((T, i))
                else:
                    kick[i] = None
            elif has_tick:
                tick_pending = False
                queued = running = 0
                for i in active:
                    queued += len(wait_q[i]) - wait_h[i]
                    running += nrun[i]
                target = autoscaler.decide(len(active), queued, running, mb)
                if target > len(active):
                    while len(active) < target:
                        spawn()
                    rebuild_active()
                while len(active) > max(target, 1):
                    drain_one(T)
                scale_events.append(ScaleEvent(T, len(active), queued,
                                               running))
                if done < n:
                    next_tick, tick_seq = T + interval, seq
                    seq += 1
                    tick_pending = True
            else:
                break
        # Admit + size every kicked instance first, then price the whole
        # wave's next steps through one batched CostGrid lookup.
        starters = []
        for i in kick:
            if busy[i]:
                continue
            if PF and nrun[i]:
                # page crossings of the carried-over batch at this step
                # (before admission registers its first-step demand)
                mapped[i] += pinc[i][kstep[i] % P]
            rows, prefill, ptoks = admit(i, T)
            bsz = nrun[i]
            if bsz == 0:
                continue
            resident = mapped[i] * P if PF \
                else sum_p[i] + bsz * kstep[i] - sum_as[i]
            starters.append((i, bsz, resident, prefill, rows, ptoks))
        if len(starters) > 1 and grid_like:
            times = cost.step_time(
                np.array([s[1] for s in starters]),
                np.array([s[2] for s in starters])).tolist()
        else:
            times = [step_scalar(s[1], s[2]) for s in starters]
        for (i, bsz, _, prefill, rows, ptoks), st in zip(starters, times):
            dt = st + prefill
            if not (dt > 0 and math.isfinite(dt)):
                raise ValueError(f"non-positive/non-finite step time {dt!r}")
            t_end = T + dt
            lrow = (T, t_end, bsz, kvres[i] * P if PF else kvres[i],
                    len(wait_q[i]) - wait_h[i], len(rows),
                    float(mapped[i]) if PF else 0.0)
            logs[i].append(lrow + (ptoks,) if OBS else lrow)
            if rows:
                # the iteration that prefills a request emits its first token
                if len(rows) <= _VEC_CUTOVER:
                    for r in rows:
                        t_first[r] = t_end
                else:
                    t_first[rows] = t_end
            busy[i] = True
            kstep[i] += 1
            heapq.heappush(heap, (t_end, seq, i))
            seq += 1

    leftovers = sum(load)
    assert done == n and leftovers == 0, "requests left in system"
    # Retirements sort by time (stable within a wave), matching the order
    # the oracle appended them while events were globally time-ordered.
    retire_records.sort(key=lambda rec: rec[0])
    retired = [i for _, i in retire_records]
    order = active + draining + retired
    return FleetResult(
        batch=b,
        metrics=SimMetrics.from_batch(b),
        step_logs=[StepLog.from_rows(logs[i]) for i in order],
        n_instances_final=len(active),
        scale_events=scale_events,
        n_instances_initial=n_instances,
    )


def _run_fleet_rich(cost, batch: RequestBatch, *, n_instances: int,
                    router: str, mb: int, cap: float,
                    paged: PagedKvSpec | None, sched: SchedPolicy,
                    autoscaler, interval: float,
                    obs: ObsConfig | None = None):
    """The rich fleet core: eviction, chunked prefill, decode-priority.

    Same event skeleton as the fast path (arrivals as sorted array +
    pointer, steps in the heap, waves draining same-timestamp events), but
    per-step state transitions are O(batch) over int-list residency
    columns — ``ctx``/``consumed``/``res_emitted`` per request, a running
    row list per instance — because these policies make occupancy depend
    on scheduling history, not just the admission step. Bit-identical to
    the ``Instance`` oracle (same plan/evict/admit/price order per
    iteration), asserted in ``tests/test_paged_kv.py``."""
    from repro_torch.serve.fleet import FleetResult, ScaleEvent

    round_robin = router == "round_robin"
    OBS = _obs_on(obs)
    b = batch.fresh()
    n = len(b)
    t_admitted, t_first, t_done = b.t_admitted, b.t_first_token, b.t_done
    tokens_emitted = b.tokens_emitted
    evict_col = b.evictions
    t_arr_l = b.t_arrival.tolist()
    rid_l = b.rid.tolist()
    prompt_l = b.prompt_tokens.tolist()
    out_l = b.output_tokens.tolist()
    kv_l = b.kv_tokens.tolist()

    step_scalar, prefill_scalar, _, per_tok = _scalar_pricer(cost)

    PF = paged is not None
    if PF:
        P = paged.page_size
        cap_pages = float("inf") if math.isinf(cap) else int(cap // P)
        budget = cap_pages * paged.oversubscription
        evict_lru = paged.eviction == "lru"
        cu_l = [(kv + P - 1) // P for kv in kv_l]
        fit_limit = cap_pages
    else:
        P = 1
        budget = cap
        evict_lru = False
        cu_l = kv_l
        fit_limit = cap
    chunk_cap = sched.prefill_chunk
    decode_pri = sched.decode_priority

    # -- per-request residency state (reset at each (re-)admission) ------------
    ctx = [0] * n        # KV tokens to (re)build: prompt + emitted-at-admit
    con = [0] * n        # prefill progress this residency
    resem = [0] * n      # tokens emitted this residency
    em = [0] * n         # tokens emitted ever (the oracle's tokens_emitted)

    # -- per-instance state ----------------------------------------------------
    busy: list[bool] = []
    committed: list = []             # commit units (pages / float tokens)
    runl: list[list[int]] = []       # running rows, admission order
    waitq: list[deque] = []          # FIFO waiting (evictees re-enter LEFT)
    planc: list[list[int]] = []      # stashed chunks of the step in flight
    plane: list[list[bool]] = []     # stashed emit flags
    logs: list[list[tuple]] = []
    load: list[int] = []

    active: list[int] = []
    draining: list[int] = []
    draining_set: set[int] = set()
    retire_records: list[tuple[float, int]] = []
    load_act = np.zeros(0, dtype=np.int64)
    posl: list[int] = []

    def rebuild_active() -> None:
        nonlocal load_act
        load_act = np.asarray([load[i] for i in active], dtype=np.int64)
        for idx in range(len(posl)):
            posl[idx] = -1
        for p, i in enumerate(active):
            posl[i] = p

    def spawn() -> None:
        i = len(busy)
        busy.append(False); committed.append(0 if PF else 0.0)
        runl.append([]); waitq.append(deque())
        planc.append([]); plane.append([])
        logs.append([]); load.append(0)
        posl.append(-1)
        active.append(i)

    def drain_one(now: float) -> None:
        if len(active) <= 1:
            return
        i = active.pop(int(load_act.argmin()))
        rebuild_active()
        if not busy[i] and load[i] == 0:
            retire_records.append((now, i))
        else:
            draining.append(i)
            draining_set.add(i)

    for _ in range(n_instances):
        spawn()
    rebuild_active()

    def start(i: int, now: float) -> float | None:
        """Plan + evict + admit + price one iteration — the oracle's
        ``start_step``, over SoA residency columns."""
        rl = runl[i]
        wq = waitq[i]
        ch: list[int] = []
        ef: list[bool] = []
        dem: list[int] = []
        D = 0
        for r in rl:
            rem_p = ctx[r] - con[r]
            c = 0 if rem_p <= 0 else \
                (rem_p if chunk_cap is None or chunk_cap >= rem_p
                 else chunk_cap)
            ch.append(c)
            ef.append(c >= rem_p)
            if PF:
                d = (con[r] + c + resem[r] + P - 1) // P
                dem.append(d)
                D += d
        ci = committed[i]
        if evict_lru and D > cap_pages:
            victims: list[int] = []
            while D > cap_pages:
                v = rl.pop(0)
                D -= dem.pop(0)
                ch.pop(0)
                ef.pop(0)
                ci -= cu_l[v]
                evict_col[v] += 1
                victims.append(v)
            for v in reversed(victims):
                wq.appendleft(v)
        nadm = 0
        mid_prefill = False
        for e in ef:
            if not e:
                mid_prefill = True
                break
        while wq and len(rl) < mb:
            if decode_pri and rl and (mid_prefill or nadm):
                break
            r = wq[0]
            if ci + cu_l[r] > budget:
                break  # FIFO: no skipping past the blocked head
            base = prompt_l[r] + em[r]
            c = base if chunk_cap is None or chunk_cap >= base else chunk_cap
            if PF:
                d = (c + P - 1) // P
                if D + d > cap_pages:
                    break  # admission must never trigger eviction
                dem.append(d)
                D += d
            wq.popleft()
            ta = t_admitted[r]
            if ta != ta:                   # NaN: first admission only
                t_admitted[r] = now
            ctx[r] = base
            con[r] = 0
            resem[r] = 0
            ci += cu_l[r]
            rl.append(r)
            ch.append(c)
            ef.append(c >= base)
            nadm += 1
        committed[i] = ci
        if not rl:
            return None
        prefill = 0.0
        resident = 0
        ptoks = 0
        for idx, r in enumerate(rl):
            c = ch[idx]
            if not PF:
                resident += con[r] + c + resem[r]
            if c:
                ptoks += c
                prefill += c * per_tok if per_tok is not None \
                    else prefill_scalar(c)
        if PF:
            resident = D * P
        dt = step_scalar(len(rl), resident) + prefill
        if not (dt > 0 and math.isfinite(dt)):
            raise ValueError(f"non-positive/non-finite step time {dt!r}")
        t_end = now + dt
        lrow = (now, t_end, len(rl), float(ci * P) if PF else ci,
                len(wq), nadm, float(D) if PF else 0.0)
        logs[i].append(lrow + (ptoks,) if OBS else lrow)
        planc[i] = ch
        plane[i] = ef
        return t_end

    def finish(i: int, now: float) -> int:
        """Replay the stashed plan — the oracle's ``finish_step``."""
        rl = runl[i]
        ch = planc[i]
        ef = plane[i]
        ci = committed[i]
        still: list[int] = []
        ndone = 0
        for idx, r in enumerate(rl):
            con[r] += ch[idx]
            if ef[idx]:
                e = em[r] + 1
                em[r] = e
                resem[r] += 1
                if e == 1:
                    t_first[r] = now
                if e >= out_l[r]:
                    t_done[r] = now
                    tokens_emitted[r] = e
                    ci -= cu_l[r]
                    ndone += 1
                    continue
            still.append(r)
        runl[i] = still
        committed[i] = ci
        return ndone

    # -- the global event loop (the fast path's skeleton, scalar calls) --------
    INF = float("inf")
    heap: list[tuple[float, int, int]] = []
    seq = n
    arr_ptr = 0
    done = 0
    clock = 0.0
    rr = 0
    scale_events: list[ScaleEvent] = []
    tick_pending = False
    next_tick, tick_seq = INF, -1
    if autoscaler is not None and n:
        tick_pending, next_tick, tick_seq = True, t_arr_l[0] + interval, seq
        seq += 1

    def _never_admissible(row: int) -> ValueError:
        if PF:
            return ValueError(
                f"request {rid_l[row]} needs {cu_l[row]} KV pages; "
                f"instance capacity is {cap_pages} — it can never be "
                f"admitted")
        return ValueError(
            f"request {rid_l[row]} needs {kv_l[row]} KV tokens; "
            f"instance capacity is {cap:.0f} — it can never be "
            f"admitted")

    while (arr_ptr < n or heap or tick_pending) and done < n:
        Ta = t_arr_l[arr_ptr] if arr_ptr < n else INF
        Tt = next_tick if tick_pending else INF
        T = Ta if Ta <= Tt else Tt
        # Fast-forward chain, as in the fast path: between interaction
        # points a popped instance runs finish->start privately.
        while heap and heap[0][0] < T:
            tcur, _, i = heapq.heappop(heap)
            pp = posl[i]
            drn = i in draining_set
            while True:
                nd = finish(i, tcur)
                if nd:
                    done += nd
                    load[i] -= nd
                    if pp >= 0:
                        load_act[pp] -= nd
                if drn and load[i] == 0:
                    draining.remove(i)
                    draining_set.discard(i)
                    retire_records.append((tcur, i))
                    busy[i] = False
                    break
                t_end = start(i, tcur)
                if t_end is None:
                    busy[i] = False
                    break
                sq = seq
                seq += 1
                if t_end >= T:
                    heapq.heappush(heap, (t_end, sq, i))
                    break
                tcur = t_end
        if T == INF or done >= n:
            break
        assert T >= clock, "fleet clock went backwards"
        clock = T
        # General wave at T (no lone-arrival shortcut here — policy steps
        # are O(batch) anyway): arrivals first, then steps/ticks by seq.
        kick: dict[int, None] = {}
        while arr_ptr < n and t_arr_l[arr_ptr] == T:
            row = arr_ptr
            if cu_l[row] > fit_limit:
                raise _never_admissible(row)
            if round_robin:
                i = active[rr % len(active)]
                rr += 1
                p = posl[i]
            elif len(active) == 1:
                i = active[0]
                p = 0
            else:
                p = load_act.argmin()
                i = active[p]
            waitq[i].append(row)
            load[i] += 1
            load_act[p] += 1
            kick[i] = None
            arr_ptr += 1
        while True:
            has_step = bool(heap) and heap[0][0] == T
            has_tick = tick_pending and next_tick == T
            if has_step and (not has_tick or heap[0][1] < tick_seq):
                _, _, i = heapq.heappop(heap)
                busy[i] = False
                nd = finish(i, T)
                if nd:
                    done += nd
                    load[i] -= nd
                    p = posl[i]
                    if p >= 0:
                        load_act[p] -= nd
                if i in draining_set and load[i] == 0:
                    draining.remove(i)
                    draining_set.discard(i)
                    retire_records.append((T, i))
                else:
                    kick[i] = None
            elif has_tick:
                tick_pending = False
                queued = running = 0
                for i in active:
                    queued += len(waitq[i])
                    running += len(runl[i])
                target = autoscaler.decide(len(active), queued, running, mb)
                if target > len(active):
                    while len(active) < target:
                        spawn()
                    rebuild_active()
                while len(active) > max(target, 1):
                    drain_one(T)
                scale_events.append(ScaleEvent(T, len(active), queued,
                                               running))
                if done < n:
                    next_tick, tick_seq = T + interval, seq
                    seq += 1
                    tick_pending = True
            else:
                break
        for i in kick:
            if busy[i]:
                continue
            t_end = start(i, T)
            if t_end is None:
                continue
            busy[i] = True
            heapq.heappush(heap, (t_end, seq, i))
            seq += 1

    leftovers = sum(load)
    assert done == n and leftovers == 0, "requests left in system"
    retire_records.sort(key=lambda rec: rec[0])
    retired = [i for _, i in retire_records]
    order = active + draining + retired
    return FleetResult(
        batch=b,
        metrics=SimMetrics.from_batch(b),
        step_logs=[StepLog.from_rows(logs[i]) for i in order],
        n_instances_final=len(active),
        scale_events=scale_events,
        n_instances_initial=n_instances,
    )
