"""Chrome ``trace_event`` / Perfetto timelines from serving results.

Everything here is post-hoc: :meth:`Timeline.derive` turns the artifacts a
finished run already carries (step-log columns, request timing columns,
autoscale events) into a struct-of-arrays timeline with pure numpy slicing
— no per-event Python work, which is why derivation is priced at <=15% of
the batched sim itself on the ``serving.obs.*`` bench row. Building the
actual ``trace_event`` dicts (:func:`trace_events` / :func:`chrome_trace`)
is presentation-layer work proportional to the event count and is benched
separately, un-floored.

Track layout (open the JSON at https://ui.perfetto.dev or
``chrome://tracing``):

* ``pid 0`` ("fleet") — counter tracks for fleet size and queued/running
  totals, sampled at every autoscale tick.
* ``pid 1..N`` ("instance i") — one lane per instance: ``X`` complete
  events per engine iteration, named ``prefill+decode`` when the step
  consumed prompt chunks (exact under ``ObsConfig(level=1)``, inferred
  from admissions otherwise) and ``decode`` when purely decoding, with
  batch / committed-KV / mapped-page args; per-instance ``C`` counters for
  queue depth and KV occupancy.
* ``pid N+1`` ("requests") — request lifecycles as nestable async spans
  (``ph: b/e`` keyed by ``id`` = rid, which Perfetto lane-packs for us):
  ``queue`` (arrival -> admission), ``prefill`` (admission -> first
  token), ``decode`` (first token -> done), plus an instant ``i`` mark on
  requests the paged allocator evicted.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

_US = 1e6                 # trace_event timestamps are microseconds
_FLEET_PID = 0
_PHASES = frozenset({"X", "C", "M", "b", "e", "i"})


@dataclass
class InstanceTrack:
    """One instance's step history (views over its :class:`StepLog`)."""

    t_start: np.ndarray
    t_end: np.ndarray
    batch: np.ndarray
    kv_reserved: np.ndarray
    queued: np.ndarray
    admitted: np.ndarray
    pages: np.ndarray
    prefill_tokens: np.ndarray | None   # exact, ObsConfig(level>=1) only
    is_prefill: np.ndarray              # bool per step

    def __len__(self) -> int:
        return len(self.t_start)


@dataclass
class Timeline:
    """Struct-of-arrays timeline derived from a SimResult/FleetResult."""

    instances: list[InstanceTrack]
    # -- request columns (arrival-sorted views) --------------------------------
    rid: np.ndarray
    t_arrival: np.ndarray
    t_admitted: np.ndarray
    t_first: np.ndarray
    t_done: np.ndarray
    prompt_tokens: np.ndarray
    output_tokens: np.ndarray
    evictions: np.ndarray
    # -- autoscale samples -----------------------------------------------------
    scale_t: np.ndarray
    scale_n: np.ndarray
    scale_queued: np.ndarray
    scale_running: np.ndarray
    # -- run envelope ----------------------------------------------------------
    t0: float
    t1: float
    paged: bool
    n_requests_total: int
    dropped_requests: int     # requests beyond max_requests (not silent)

    @classmethod
    def derive(cls, result, max_requests: int | None = None) -> "Timeline":
        """Vectorized derivation — numpy slicing only, no per-event work.

        ``max_requests`` caps the request-lane columns (instance lanes and
        counters always cover the full run); the drop count is kept on the
        timeline and surfaced in the export, never silent."""
        batch, logs, events = _unpack(result)
        n_total = len(batch)
        keep = n_total if max_requests is None \
            else max(0, min(int(max_requests), n_total))

        tracks = []
        paged = False
        for log in logs:
            pf = log.prefill_tokens
            if pf is not None:
                is_pref = pf > 0
            else:
                # level 0: admission implies prompt consumption on the fast
                # path; a chunked-prefill run needs level 1 for exact labels
                is_pref = log.admitted > 0
            paged = paged or bool(len(log.pages) and log.pages.any())
            tracks.append(InstanceTrack(
                t_start=log.t_start, t_end=log.t_end, batch=log.batch,
                kv_reserved=log.kv_reserved, queued=log.queued,
                admitted=log.admitted, pages=log.pages,
                prefill_tokens=pf, is_prefill=is_pref))

        scale_t = np.array([e.t for e in events], dtype=float)
        scale_n = np.array([e.n_active for e in events], dtype=np.int64)
        scale_q = np.array([e.queued for e in events], dtype=np.int64)
        scale_r = np.array([e.running for e in events], dtype=np.int64)

        t0 = float(batch.t_arrival.min()) if n_total else 0.0
        highs = [float(tr.t_end.max()) for tr in tracks if len(tr)]
        if n_total:
            highs.append(float(batch.t_done.max()))
        t1 = max(highs) if highs else 0.0
        return cls(
            instances=tracks,
            rid=batch.rid[:keep], t_arrival=batch.t_arrival[:keep],
            t_admitted=batch.t_admitted[:keep],
            t_first=batch.t_first_token[:keep], t_done=batch.t_done[:keep],
            prompt_tokens=batch.prompt_tokens[:keep],
            output_tokens=batch.output_tokens[:keep],
            evictions=batch.evictions[:keep],
            scale_t=scale_t, scale_n=scale_n, scale_queued=scale_q,
            scale_running=scale_r,
            t0=t0, t1=t1, paged=paged,
            n_requests_total=n_total, dropped_requests=n_total - keep)

    @property
    def n_steps_total(self) -> int:
        return sum(len(tr) for tr in self.instances)


def _unpack(result):
    """(RequestBatch, step logs, scale events) from either result type."""
    if hasattr(result, "step_logs"):        # FleetResult
        return result.batch, result.step_logs, result.scale_events
    from repro_torch.serve.sim import RequestBatch

    return (RequestBatch.from_completed(result.requests),
            [result.step_log], [])


def trace_events(result, *, max_requests: int | None = None) -> list[dict]:
    """The flat ``traceEvents`` list for ``result`` (see module docstring
    for the track layout). Accepts a result object or a pre-derived
    :class:`Timeline`."""
    tl = result if isinstance(result, Timeline) \
        else Timeline.derive(result, max_requests=max_requests)
    ev: list[dict] = []
    add = ev.append

    # -- fleet-wide process + autoscale counters -------------------------------
    add({"ph": "M", "name": "process_name", "pid": _FLEET_PID, "tid": 0,
         "ts": 0, "args": {"name": "fleet"}})
    for t, nact, q, r in zip(tl.scale_t.tolist(), tl.scale_n.tolist(),
                             tl.scale_queued.tolist(),
                             tl.scale_running.tolist()):
        ts = t * _US
        add({"ph": "C", "name": "fleet size", "pid": _FLEET_PID, "tid": 0,
             "ts": ts, "args": {"instances": nact}})
        add({"ph": "C", "name": "fleet load", "pid": _FLEET_PID, "tid": 0,
             "ts": ts, "args": {"queued": q, "running": r}})

    # -- one lane per instance -------------------------------------------------
    for idx, tr in enumerate(tl.instances):
        pid = idx + 1
        add({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "ts": 0, "args": {"name": f"instance {idx}"}})
        add({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
             "ts": 0, "args": {"name": "steps"}})
        ts_l = (tr.t_start * _US).tolist()
        dur_l = ((tr.t_end - tr.t_start) * _US).tolist()
        b_l = tr.batch.tolist()
        kv_l = tr.kv_reserved.tolist()
        q_l = tr.queued.tolist()
        adm_l = tr.admitted.tolist()
        pg_l = tr.pages.tolist()
        pf_l = None if tr.prefill_tokens is None \
            else tr.prefill_tokens.tolist()
        pref_l = tr.is_prefill.tolist()
        for k in range(len(ts_l)):
            args = {"batch": b_l[k], "kv_committed_tokens": kv_l[k],
                    "admitted": adm_l[k]}
            if tl.paged:
                args["mapped_pages"] = pg_l[k]
            if pf_l is not None:
                args["prefill_tokens"] = pf_l[k]
            add({"ph": "X", "name": ("prefill+decode" if pref_l[k]
                                     else "decode"),
                 "pid": pid, "tid": 0, "ts": ts_l[k], "dur": dur_l[k],
                 "args": args})
            add({"ph": "C", "name": "queue depth", "pid": pid, "tid": 0,
                 "ts": ts_l[k], "args": {"queued": q_l[k]}})
            add({"ph": "C", "name": "kv occupancy", "pid": pid, "tid": 0,
                 "ts": ts_l[k],
                 "args": ({"mapped_pages": pg_l[k]} if tl.paged
                          else {"committed_tokens": kv_l[k]})})

    # -- request lifecycles (nestable async spans, lane-packed by id) ----------
    rpid = len(tl.instances) + 1
    add({"ph": "M", "name": "process_name", "pid": rpid, "tid": 0,
         "ts": 0, "args": {"name": "requests"}})
    rid_l = tl.rid.tolist()
    arr_l = (tl.t_arrival * _US).tolist()
    adm_l = (tl.t_admitted * _US).tolist()
    first_l = (tl.t_first * _US).tolist()
    done_l = (tl.t_done * _US).tolist()
    p_l = tl.prompt_tokens.tolist()
    o_l = tl.output_tokens.tolist()
    ev_l = tl.evictions.tolist()
    for k in range(len(rid_l)):
        rid = rid_l[k]
        base = {"cat": "request", "id": rid, "pid": rpid, "tid": 0}
        add({"ph": "b", "name": "queue", "ts": arr_l[k],
             "args": {"rid": rid, "prompt_tokens": p_l[k],
                      "output_tokens": o_l[k]}, **base})
        add({"ph": "e", "name": "queue", "ts": adm_l[k], **base})
        add({"ph": "b", "name": "prefill", "ts": adm_l[k], **base})
        add({"ph": "e", "name": "prefill", "ts": first_l[k], **base})
        if done_l[k] > first_l[k]:
            add({"ph": "b", "name": "decode", "ts": first_l[k], **base})
            add({"ph": "e", "name": "decode", "ts": done_l[k], **base})
        if ev_l[k]:
            add({"ph": "i", "name": "evicted", "s": "p", "pid": rpid,
                 "tid": 0, "ts": first_l[k], "args": {"rid": rid,
                                                      "evictions": ev_l[k]}})
    return ev


def chrome_trace(result, *, max_requests: int | None = None) -> dict:
    """The full Chrome trace document (``{"traceEvents": [...], ...}``)."""
    tl = result if isinstance(result, Timeline) \
        else Timeline.derive(result, max_requests=max_requests)
    return {
        "traceEvents": trace_events(tl),
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro.obs",     # the JAX package's name: traces compare equal
            "n_instances": len(tl.instances),
            "n_requests": tl.n_requests_total - tl.dropped_requests,
            "n_steps": tl.n_steps_total,
            "dropped_requests": tl.dropped_requests,
            "span_s": tl.t1 - tl.t0,
        },
    }


def write_chrome_trace(path, result, *,
                       max_requests: int | None = None) -> dict:
    """Serialize :func:`chrome_trace` to ``path``; returns the document."""
    doc = chrome_trace(result, max_requests=max_requests)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc) -> list[str]:
    """Schema-check a trace document; returns problems (empty == valid).

    Covers what Perfetto/chrome://tracing need to load the file: known
    ``ph``, numeric non-negative ``ts`` (and ``dur`` for ``X``), integer
    ``pid``/``tid``, ``id`` on nestable async events, numeric counter args,
    and per-(pid, name) counters monotone non-decreasing in ``ts``."""
    probs: list[str] = []
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    counter_ts: dict[tuple, float] = {}
    open_async: dict[tuple, int] = {}
    for k, e in enumerate(events):
        if not isinstance(e, dict):
            probs.append(f"event {k}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            probs.append(f"event {k}: unknown ph {ph!r}")
            continue
        for key in ("pid", "tid"):
            v = e.get(key)
            if not isinstance(v, int) or v < 0:
                probs.append(f"event {k}: bad {key} {v!r}")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or not np.isfinite(ts) or ts < 0:
            probs.append(f"event {k}: bad ts {ts!r}")
            continue
        if not isinstance(e.get("name"), str):
            probs.append(f"event {k}: missing name")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or not np.isfinite(dur) \
                    or dur < 0:
                probs.append(f"event {k}: bad dur {dur!r}")
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                probs.append(f"event {k}: counter args must be numbers")
            key = (e.get("pid"), e.get("name"))
            if ts < counter_ts.get(key, float("-inf")):
                probs.append(
                    f"event {k}: counter {key[1]!r} ts not monotone")
            counter_ts[key] = ts
        elif ph in ("b", "e"):
            if "id" not in e:
                probs.append(f"event {k}: async event without id")
            key = (e.get("cat"), e.get("id"), e.get("name"))
            open_async[key] = open_async.get(key, 0) + (1 if ph == "b"
                                                        else -1)
            if open_async[key] < 0:
                probs.append(f"event {k}: async end without begin {key!r}")
    for key, depth in open_async.items():
        if depth != 0:
            probs.append(f"unbalanced async span {key!r} (depth {depth})")
    return probs
