"""The kernel x shape matrix the analyser runs over.

The reference's eight cases, by their names (``workloads/kernels`` of the
analytic stack enumerates them), at their shapes through the port's plans;
then the port's own path shapes (``PERF.md`` section 6): K1 at serving,
training and MLA's prefill, K2 at training and MLA's training, K3 at
serving, the hybrid's shared block, a 32k cache and the partial entry, K4 at
T = 2048, 256 and 4, K5 at the prefill, N = 128 and S = 8192.

K3's cluster size is the card's (``kernels.flash_decode.launch_plan``
shrinks ``decode_plan``'s until one wave holds the launch): where a card is
present the caller passes ``decode_cluster(b, h, kvh, s, d, dtype,
partial)``, and without one the plan's own is kept.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.check import facts as F

BF16, FP32 = torch.bfloat16, torch.float32


@dataclass(frozen=True)
class KernelCase:
    """One (kernel, shape) point: ``build(decode_cluster)`` gives its facts."""

    kernel: str
    case: str
    build: Callable[..., list]

    @property
    def name(self) -> str:
        return f"{self.kernel}.{self.case}"


def _flash_attention(case, b, s, h, kvh, d, dt, causal, dv=None):
    return KernelCase("flash_attention", case, lambda _=None: F.k1_facts(
        case, b, s, s, h, kvh, d, dv or d, dt, causal))


def _flash_attention_bwd(case, b, s, h, kvh, d, dt, causal, dv=None):
    return KernelCase("flash_attention_bwd", case, lambda _=None: F.k2_facts(
        case, b, s, s, h, kvh, d, dv or d, dt, causal))


def _flash_decode(case, b, s, h, kvh, d, dt, kv_len, partial=False):
    def build(decode_cluster=None):
        c = None if decode_cluster is None else decode_cluster(b, h, kvh, s, d, dt, partial)
        return F.k3_facts(case, b, h, kvh, d, s, kv_len, dt, partial=partial, cluster=c)
    return KernelCase("flash_decode", case, build)


def _fused_ffn(case, t, d, f, dt):
    return KernelCase("fused_ffn", case, lambda _=None: F.k4_facts(case, t, d, f, dt))


def _ssd_scan(case, b, s, h, p, n, dt):
    return KernelCase("ssd_scan", case, lambda _=None: F.k5_facts(case, b, s, h, p, n, dt))


CASES: tuple[KernelCase, ...] = (
    # the reference's matrix, by name
    _flash_attention("b2s512", b=2, s=512, h=8, kvh=4, d=128, dt=BF16, causal=True),
    _flash_attention("b1s1024f32", b=1, s=1024, h=4, kvh=4, d=128, dt=FP32, causal=False),
    _flash_attention_bwd("b2s512", b=2, s=512, h=8, kvh=4, d=128, dt=BF16, causal=True),
    _flash_decode("b2s2048", b=2, s=2048, h=8, kvh=4, d=128, dt=BF16, kv_len=2048),
    _flash_decode("b1s4096", b=1, s=4096, h=8, kvh=8, d=128, dt=BF16, kv_len=4096),
    _fused_ffn("t512d1024", t=512, d=1024, f=2048, dt=BF16),
    _fused_ffn("t256d512f32", t=256, d=512, f=1024, dt=FP32),
    _ssd_scan("b2s1024", b=2, s=1024, h=4, p=64, n=128, dt=BF16),
    # the port's path shapes
    _flash_attention("serve", b=4, s=512, h=32, kvh=4, d=64, dt=BF16, causal=True),
    _flash_attention("train", b=4, s=1024, h=32, kvh=4, d=64, dt=BF16, causal=True),
    _flash_attention("mla", b=4, s=512, h=128, kvh=128, d=192, dv=128, dt=BF16, causal=True),
    _flash_attention_bwd("train", b=4, s=1024, h=32, kvh=4, d=64, dt=BF16, causal=True),
    _flash_attention_bwd("mla", b=4, s=1024, h=128, kvh=128, d=192, dv=128, dt=BF16,
                         causal=True),
    _flash_decode("serve", b=4, s=1024, h=32, kvh=4, d=64, dt=BF16, kv_len=543),
    _flash_decode("hybrid", b=4, s=1024, h=32, kvh=32, d=64, dt=BF16, kv_len=527),
    _flash_decode("32k", b=1, s=32768, h=32, kvh=8, d=128, dt=BF16, kv_len=32768),
    _flash_decode("partial", b=4, s=1024, h=32, kvh=4, d=64, dt=BF16, kv_len=543, partial=True),
    _fused_ffn("t2048", t=2048, d=2048, f=8192, dt=BF16),
    _fused_ffn("t256", t=256, d=2048, f=8192, dt=BF16),
    _fused_ffn("t4", t=4, d=2048, f=8192, dt=BF16),
    _ssd_scan("prefill", b=4, s=512, h=64, p=64, n=64, dt=BF16),
    _ssd_scan("n128", b=4, s=512, h=64, p=64, n=128, dt=BF16),
    _ssd_scan("s8192", b=1, s=8192, h=64, p=64, n=64, dt=BF16),
)

REFERENCE_CASES = tuple(c.name for c in CASES[:8])
_BY_NAME = {c.name: c for c in CASES}


def case_names() -> list[str]:
    return [c.name for c in CASES]


def get(name: str) -> KernelCase:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown kernel case {name!r}; known: {case_names()}") from None


def trace_case(name: str, decode_cluster=None) -> list:
    """The KernelFacts of one catalog case."""
    return get(name).build(decode_cluster)


def trace_all(names=None, decode_cluster=None) -> list:
    """KernelFacts of the cases ``names`` (default all), in catalog order."""
    out = []
    for name in names or case_names():
        out.extend(trace_case(name, decode_cluster))
    return out
