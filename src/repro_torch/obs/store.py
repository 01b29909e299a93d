"""Persist a ``FleetResult`` as one ``.npz`` so the CLI can run the sim
once and derive traces / timeseries / tables from the saved artifact.

Columnar all the way down: the request batch saves as its SoA columns, the
per-instance step logs concatenate onto one axis with an offsets vector
(exactly how the batched engine thinks about them), and scale events save
as four parallel arrays. ``load_result`` rebuilds a ``FleetResult`` whose
metrics are recomputed from the batch — the saved file carries raw
artifacts, never derived numbers that could go stale."""
from __future__ import annotations

import numpy as np

# the file format's name, shared with the JAX package: each loads the other's files
_SCHEMA = "repro.obs.result/v1"


def save_result(path, result) -> None:
    """Save a ``FleetResult`` (or anything shaped like one: ``batch``,
    ``step_logs``, ``scale_events``, instance counts) to ``path``."""
    b = result.batch
    logs = result.step_logs
    offsets = np.cumsum([0] + [len(sl.t_start) for sl in logs])

    def cat(name):
        cols = [getattr(sl, name) for sl in logs]
        return np.concatenate(cols) if cols else np.zeros(0)

    has_pf = bool(logs) and all(sl.prefill_tokens is not None for sl in logs)
    ev = result.scale_events
    n_init = result.n_instances_initial
    arrays = {
        "schema": np.array(_SCHEMA),
        "rid": b.rid, "t_arrival": b.t_arrival,
        "prompt_tokens": b.prompt_tokens, "output_tokens": b.output_tokens,
        "t_admitted": b.t_admitted, "t_first_token": b.t_first_token,
        "t_done": b.t_done, "tokens_emitted": b.tokens_emitted,
        "evictions": b.evictions,
        "log_offsets": offsets,
        "log_t_start": cat("t_start"), "log_t_end": cat("t_end"),
        "log_batch": cat("batch"), "log_kv_reserved": cat("kv_reserved"),
        "log_queued": cat("queued"), "log_admitted": cat("admitted"),
        "log_pages": cat("pages"),
        "scale_t": np.array([e.t for e in ev], dtype=float),
        "scale_n": np.array([e.n_active for e in ev], dtype=np.int64),
        "scale_queued": np.array([e.queued for e in ev], dtype=np.int64),
        "scale_running": np.array([e.running for e in ev], dtype=np.int64),
        "n_instances_final": np.int64(result.n_instances_final),
        "n_instances_initial": np.int64(
            n_init if n_init is not None else -1),
    }
    if has_pf:
        arrays["log_prefill_tokens"] = cat("prefill_tokens")
    np.savez_compressed(path, **arrays)


def load_result(path):
    """Rebuild the ``FleetResult`` saved by :func:`save_result` (metrics
    recomputed from the request columns)."""
    from repro_torch.serve.fleet import FleetResult, ScaleEvent
    from repro_torch.serve.sim import RequestBatch, SimMetrics, StepLog

    with np.load(path, allow_pickle=False) as z:
        schema = str(z["schema"])
        if schema != _SCHEMA:
            raise ValueError(f"{path}: schema {schema!r}, "
                             f"expected {_SCHEMA!r}")
        batch = RequestBatch(
            rid=z["rid"], t_arrival=z["t_arrival"],
            prompt_tokens=z["prompt_tokens"],
            output_tokens=z["output_tokens"],
            t_admitted=z["t_admitted"], t_first_token=z["t_first_token"],
            t_done=z["t_done"], tokens_emitted=z["tokens_emitted"],
            evictions=z["evictions"])
        off = z["log_offsets"]
        pf = z["log_prefill_tokens"] if "log_prefill_tokens" in z else None
        logs = []
        for i in range(len(off) - 1):
            sl = slice(int(off[i]), int(off[i + 1]))
            logs.append(StepLog(
                t_start=z["log_t_start"][sl], t_end=z["log_t_end"][sl],
                batch=z["log_batch"][sl].astype(int),
                kv_reserved=z["log_kv_reserved"][sl],
                queued=z["log_queued"][sl].astype(int),
                admitted=z["log_admitted"][sl].astype(int),
                pages=z["log_pages"][sl].astype(int),
                prefill_tokens=None if pf is None else pf[sl].astype(int)))
        events = [ScaleEvent(t=float(t), n_active=int(n), queued=int(q),
                             running=int(r))
                  for t, n, q, r in zip(z["scale_t"], z["scale_n"],
                                        z["scale_queued"],
                                        z["scale_running"])]
        n_init = int(z["n_instances_initial"])
        return FleetResult(
            batch=batch, metrics=SimMetrics.from_batch(batch),
            step_logs=logs,
            n_instances_final=int(z["n_instances_final"]),
            scale_events=events,
            n_instances_initial=None if n_init < 0 else n_init)
