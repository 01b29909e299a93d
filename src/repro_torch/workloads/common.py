"""Layer-graph builder that emits one-iteration tensor traces.

A workload is described once as a forward graph of primitive layers; the
builder derives the backward pass (dgrad + wgrad per layer, reverse order)
and the optimizer step, emitting :class:`repro_torch.core.trace.Op` records with
correct FLOP counts, tensor sizes and kernel parallelism. This mirrors the
paper's methodology of tracing one *end-to-end* iteration (fwd+bwd+update)
rather than isolated kernels, which is what exposes inter-kernel reuse.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.trace import BYTES, Trace, gemm_parallelism


@dataclass
class LayerRec:
    kind: str                 # gemm | conv | dwconv | eltwise | reduce | gather
    name: str
    flops: float
    x: str | None             # input activation tensor (None = graph input)
    w: str | None             # weight tensor (None = no params)
    y: str                    # output activation tensor
    x_bytes: int
    w_bytes: int
    y_bytes: int
    extra_reads: tuple[tuple[str, int], ...] = ()
    extra_writes: tuple[tuple[str, int], ...] = ()
    parallelism: float = float("inf")
    bwd_flop_scale: float = 2.0   # dgrad+wgrad ≈ 2x fwd for gemm/conv
    trainable: bool = True
    stash_for_bwd: bool = True    # activation needed again in backward


class ModelBuilder:
    """Collects layers; ``trace()`` emits fwd [+ bwd + optimizer]."""

    def __init__(self, name: str, precision: str = "fp16"):
        self.name = name
        self.precision = precision
        self.layers: list[LayerRec] = []
        self._uid = 0

    # ---- naming ----------------------------------------------------------------
    def fresh(self, stem: str) -> str:
        self._uid += 1
        return f"{stem}.{self._uid}"

    def dtype_bytes(self) -> int:
        return BYTES[self.precision]

    # ---- primitive layers --------------------------------------------------------
    def gemm(self, name: str, x: str | None, m: int, k: int, n: int,
             x_bytes: int | None = None, weight: bool = True,
             shared_w: str | None = None) -> str:
        e = self.dtype_bytes()
        y = self.fresh(f"{name}.out")
        w_name = shared_w if shared_w else (self.fresh(f"{name}.w") if weight else None)
        self.layers.append(LayerRec(
            kind="gemm", name=name, flops=2.0 * m * k * n,
            x=x, w=w_name if weight else None, y=y,
            x_bytes=x_bytes if x_bytes is not None else m * k * e,
            w_bytes=k * n * e if weight else 0,
            y_bytes=m * n * e,
            parallelism=gemm_parallelism(m, n),
        ))
        return y

    def conv(self, name: str, x: str | None, n: int, h: int, w: int, cin: int,
             cout: int, kh: int, kw: int, stride: int = 1) -> tuple[str, int, int]:
        """Returns (out_tensor, out_h, out_w)."""
        e = self.dtype_bytes()
        oh, ow = math.ceil(h / stride), math.ceil(w / stride)
        y = self.fresh(f"{name}.out")
        self.layers.append(LayerRec(
            kind="conv", name=name,
            flops=2.0 * n * oh * ow * cout * cin * kh * kw,
            x=x, w=self.fresh(f"{name}.w"), y=y,
            x_bytes=n * h * w * cin * e,
            w_bytes=cout * cin * kh * kw * e,
            y_bytes=n * oh * ow * cout * e,
            parallelism=gemm_parallelism(n * oh * ow, cout),
        ))
        return y, oh, ow

    def dwconv(self, name: str, x: str | None, n: int, h: int, w: int, c: int,
               kh: int, kw: int, stride: int = 1) -> tuple[str, int, int]:
        e = self.dtype_bytes()
        oh, ow = math.ceil(h / stride), math.ceil(w / stride)
        y = self.fresh(f"{name}.out")
        self.layers.append(LayerRec(
            kind="dwconv", name=name,
            flops=2.0 * n * oh * ow * c * kh * kw,
            x=x, w=self.fresh(f"{name}.w"), y=y,
            x_bytes=n * h * w * c * e,
            w_bytes=c * kh * kw * e,
            y_bytes=n * oh * ow * c * e,
            parallelism=float(n * oh * ow * c),
        ))
        return y, oh, ow

    def eltwise(self, name: str, x: str | None, nbytes: int,
                flops_per_byte: float = 0.5, extra_reads: tuple = (),
                trainable: bool = False, stash: bool = True,
                w_bytes: int = 0) -> str:
        """BN/ReLU/residual-add/softmax-ish kernels: BW-bound by design."""
        y = self.fresh(f"{name}.out")
        self.layers.append(LayerRec(
            kind="eltwise", name=name, flops=nbytes * flops_per_byte,
            x=x, w=self.fresh(f"{name}.w") if trainable else None, y=y,
            x_bytes=nbytes, w_bytes=w_bytes, y_bytes=nbytes,
            extra_reads=tuple(extra_reads),
            parallelism=float(nbytes // self.dtype_bytes()),
            bwd_flop_scale=1.0, trainable=trainable, stash_for_bwd=stash,
        ))
        return y

    def emit(self, name: str, flops: float, reads=(), writes=(),
             parallelism: float = float("inf")) -> str:
        """Raw op passthrough (custom fused kernels, cache reads, SSD scans).
        First write is the nominal output; backward (when training) reads
        d.out + the forward reads and writes d.<first-read>."""
        writes = tuple(writes)
        reads = tuple(reads)
        y, y_bytes = writes[0]
        self.layers.append(LayerRec(
            kind="raw", name=name, flops=flops, x=None, w=None, y=y,
            x_bytes=0, w_bytes=0, y_bytes=y_bytes,
            extra_reads=reads, extra_writes=writes[1:],
            parallelism=parallelism, bwd_flop_scale=1.5, trainable=False,
        ))
        return y

    def gather(self, name: str, table_bytes: int, gathered_bytes: int,
               trainable: bool = True) -> str:
        """Embedding lookup: reads a *fraction* of a big table."""
        y = self.fresh(f"{name}.out")
        self.layers.append(LayerRec(
            kind="gather", name=name, flops=gathered_bytes * 0.1,
            x=None, w=self.fresh(f"{name}.table"), y=y,
            x_bytes=0, w_bytes=min(table_bytes, gathered_bytes), y_bytes=gathered_bytes,
            parallelism=float(gathered_bytes // self.dtype_bytes()),
            bwd_flop_scale=1.0, trainable=trainable,
        ))
        # The full table participates in the optimizer step.
        self.layers[-1].extra_reads = (("__tablesize__", table_bytes),)
        return y

    def attention(self, name: str, x: str, b: int, s_q: int, s_kv: int,
                  heads: int, dim: int, kv_heads: int | None = None,
                  chunked: bool = True, causal: bool = True) -> str:
        """QKV proj + SDPA + out proj. ``chunked`` = flash-style (the score
        matrix never leaves on-chip memory: no S tensor in the trace)."""
        e = self.dtype_bytes()
        kvh = kv_heads or heads
        d_model = heads * dim
        q = self.gemm(f"{name}.q", x, b * s_q, d_model, heads * dim)
        k = self.gemm(f"{name}.k", x, b * s_q if s_q == s_kv else b * s_kv,
                      d_model, kvh * dim, x_bytes=b * s_kv * d_model * e)
        v = self.gemm(f"{name}.v", x, b * s_kv, d_model, kvh * dim,
                      x_bytes=b * s_kv * d_model * e)
        sdpa_flops = 2.0 * 2.0 * b * heads * s_q * s_kv * dim
        if causal and s_q == s_kv:
            sdpa_flops *= 0.5
        y = self.fresh(f"{name}.sdpa.out")
        reads = [(q, b * s_q * heads * dim * e),
                 (k, b * s_kv * kvh * dim * e),
                 (v, b * s_kv * kvh * dim * e)]
        writes_bytes = b * s_q * heads * dim * e
        if not chunked:
            # naive attention materializes the score matrix twice (S, P)
            s_bytes = b * heads * s_q * s_kv * e
            smat = self.fresh(f"{name}.scores")
            self.layers.append(LayerRec(
                kind="eltwise", name=f"{name}.scores", flops=sdpa_flops / 2,
                x=None, w=None, y=smat, x_bytes=0, w_bytes=0, y_bytes=s_bytes,
                extra_reads=tuple(reads[:2]),
                parallelism=gemm_parallelism(b * heads * s_q, s_kv),
                bwd_flop_scale=2.0, trainable=False,
            ))
            self.layers.append(LayerRec(
                kind="eltwise", name=f"{name}.pv", flops=sdpa_flops / 2,
                x=smat, w=None, y=y, x_bytes=s_bytes, w_bytes=0,
                y_bytes=writes_bytes, extra_reads=(reads[2],),
                parallelism=gemm_parallelism(b * heads * s_q, dim),
                bwd_flop_scale=2.0, trainable=False,
            ))
        else:
            self.layers.append(LayerRec(
                kind="gemm", name=f"{name}.sdpa", flops=sdpa_flops,
                x=q, w=None, y=y,
                x_bytes=b * s_q * heads * dim * e, w_bytes=0,
                y_bytes=writes_bytes, extra_reads=tuple(reads[1:]),
                parallelism=gemm_parallelism(b * heads * s_q, dim),
                bwd_flop_scale=2.5,  # flash bwd recomputes scores
            ))
        return self.gemm(f"{name}.o", y, b * s_q, heads * dim, d_model)

    # ---- trace emission ------------------------------------------------------------
    def param_tensors(self) -> list[tuple[str, int]]:
        out: dict[str, int] = {}
        for l in self.layers:
            if l.w is not None and l.trainable:
                full = l.w_bytes
                for t, b in l.extra_reads:
                    if t == "__tablesize__":
                        full = b
                out[l.w] = max(out.get(l.w, 0), full)
        return list(out.items())

    def n_params(self) -> float:
        return sum(b for _, b in self.param_tensors()) / self.dtype_bytes()

    def trace(self, training: bool, batch_size: int = 0,
              optimizer: str = "adam") -> Trace:
        tr = Trace(self.name, batch_size=batch_size,
                   kind="training" if training else "inference")
        e = self.dtype_bytes()
        # ---- forward ----
        for l in self.layers:
            reads = []
            if l.x is not None and l.x_bytes:
                reads.append((l.x, l.x_bytes))
            if l.w is not None and l.w_bytes:
                reads.append((l.w, l.w_bytes))
            reads += [(t, b) for t, b in l.extra_reads if t != "__tablesize__"]
            tr.emit(f"fwd.{l.name}", l.flops, reads=reads,
                    writes=[(l.y, l.y_bytes)] + list(l.extra_writes),
                    precision=self.precision, parallelism=l.parallelism)
        if not training:
            return tr
        # ---- backward (reverse order): dgrad reads dy+w, wgrad reads dy+x ----
        for l in reversed(self.layers):
            dy = f"d.{l.y}"
            if l.kind == "raw":
                if l.extra_reads:
                    src = l.extra_reads[0][0]
                    tr.emit(f"bwd.{l.name}", l.flops * l.bwd_flop_scale,
                            reads=[(dy, l.y_bytes)] + list(l.extra_reads),
                            writes=[(f"d.{src}", l.extra_reads[0][1])],
                            precision=self.precision,
                            parallelism=l.parallelism)
                continue
            dgrad_reads = [(dy, l.y_bytes)]
            if l.w is not None and l.w_bytes:
                dgrad_reads.append((l.w, l.w_bytes))
            if l.stash_for_bwd and l.kind in ("eltwise", "gather") and l.x:
                dgrad_reads.append((l.x, l.x_bytes))
            if l.x is not None and l.x_bytes:
                tr.emit(f"bwd.dgrad.{l.name}", l.flops * (l.bwd_flop_scale / 2.0),
                        reads=dgrad_reads, writes=[(f"d.{l.x}", l.x_bytes)],
                        precision=self.precision, parallelism=l.parallelism)
            if l.w is not None and l.trainable:
                wgrad_reads = [(dy, l.y_bytes)]
                if l.x is not None and l.x_bytes and l.stash_for_bwd:
                    wgrad_reads.append((l.x, l.x_bytes))
                gsize = l.w_bytes
                for t, b in l.extra_reads:
                    if t == "__tablesize__":
                        gsize = min(gsize, b)
                tr.emit(f"bwd.wgrad.{l.name}", l.flops * (l.bwd_flop_scale / 2.0),
                        reads=wgrad_reads, writes=[(f"g.{l.w}", gsize)],
                        precision=self.precision, parallelism=l.parallelism)
        # ---- optimizer: fp32 master + moments (mixed-precision recipe) ----
        n_states = {"adam": 2, "sgdm": 1, "sgd": 0}[optimizer]
        for w, nbytes in self.param_tensors():
            n_el = nbytes // e
            master = n_el * 4
            reads = [(f"g.{w}", nbytes), (f"m32.{w}", master)]
            writes = [(w, nbytes), (f"m32.{w}", master)]
            for i in range(n_states):
                reads.append((f"opt{i}.{w}", master))
                writes.append((f"opt{i}.{w}", master))
            tr.emit(f"opt.{w}", flops=n_el * (4 + 4 * n_states), reads=reads,
                    writes=writes, precision="fp32", parallelism=float(n_el))
        return tr
