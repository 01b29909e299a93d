"""The port's static analyser (``repro_torch.check``): facts built from the
kernels' launch plans, rules R1-R5 for ``sm_90a``, the touch streams, the
catalog, the ``ptxas`` report and the CLI.

The reference's analyser cannot be the oracle (it fails on the installed
jax, ``src/repro/check/facts.py:320``, and its rules speak of the TPU), so
the streams are held to closed forms: for every catalog case, each launch's
unique-tile bytes are each of its inputs and outputs once, and its FLOPs the
tile-granular products. Each rule fires on a planted faulty plan and names
the kernel's ``.cu`` file and line. The constants that live only in the CUDA
source are tied to it by regex."""
import dataclasses
import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.check import catalog as reference_catalog
from repro_torch.check import catalog, cli, facts as F, ptxas, rules, streams
from repro_torch.check.rules import Finding, apply_waivers, coverage, run_rules
from repro_torch.kernels import flash_attention_bwd as k2
from repro_torch.kernels import flash_decode as k3
from repro_torch.kernels import fused_ffn as k4
from repro_torch.kernels import ssd_scan as k5
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
BF16, FP32 = torch.bfloat16, torch.float32

# every catalog case's shape, restated: (kind, parameters)
SHAPES = {
    "flash_attention.b2s512": ("attn", dict(b=2, s=512, h=8, kvh=4, d=128, dv=128, dt=BF16,
                                            causal=True)),
    "flash_attention.b1s1024f32": ("attn", dict(b=1, s=1024, h=4, kvh=4, d=128, dv=128, dt=FP32,
                                                causal=False)),
    "flash_attention_bwd.b2s512": ("bwd", dict(b=2, s=512, h=8, kvh=4, d=128, dv=128, dt=BF16,
                                               causal=True)),
    "flash_decode.b2s2048": ("decode", dict(b=2, s=2048, h=8, kvh=4, d=128, kv_len=2048)),
    "flash_decode.b1s4096": ("decode", dict(b=1, s=4096, h=8, kvh=8, d=128, kv_len=4096)),
    "fused_ffn.t512d1024": ("ffn", dict(t=512, d=1024, f=2048, dt=BF16)),
    "fused_ffn.t256d512f32": ("ffn", dict(t=256, d=512, f=1024, dt=FP32)),
    "ssd_scan.b2s1024": ("ssd", dict(b=2, s=1024, h=4, p=64, n=128)),
    "flash_attention.serve": ("attn", dict(b=4, s=512, h=32, kvh=4, d=64, dv=64, dt=BF16,
                                           causal=True)),
    "flash_attention.train": ("attn", dict(b=4, s=1024, h=32, kvh=4, d=64, dv=64, dt=BF16,
                                           causal=True)),
    "flash_attention.mla": ("attn", dict(b=4, s=512, h=128, kvh=128, d=192, dv=128, dt=BF16,
                                         causal=True)),
    "flash_attention_bwd.train": ("bwd", dict(b=4, s=1024, h=32, kvh=4, d=64, dv=64, dt=BF16,
                                              causal=True)),
    "flash_attention_bwd.mla": ("bwd", dict(b=4, s=1024, h=128, kvh=128, d=192, dv=128,
                                            dt=BF16, causal=True)),
    "flash_decode.serve": ("decode", dict(b=4, s=1024, h=32, kvh=4, d=64, kv_len=543)),
    "flash_decode.hybrid": ("decode", dict(b=4, s=1024, h=32, kvh=32, d=64, kv_len=527)),
    "flash_decode.32k": ("decode", dict(b=1, s=32768, h=32, kvh=8, d=128, kv_len=32768)),
    "flash_decode.partial": ("decode", dict(b=4, s=1024, h=32, kvh=4, d=64, kv_len=543,
                                            partial=True)),
    "fused_ffn.t2048": ("ffn", dict(t=2048, d=2048, f=8192, dt=BF16)),
    "fused_ffn.t256": ("ffn", dict(t=256, d=2048, f=8192, dt=BF16)),
    "fused_ffn.t4": ("ffn", dict(t=4, d=2048, f=8192, dt=BF16)),
    "ssd_scan.prefill": ("ssd", dict(b=4, s=512, h=64, p=64, n=64)),
    "ssd_scan.n128": ("ssd", dict(b=4, s=512, h=64, p=64, n=128)),
    "ssd_scan.s8192": ("ssd", dict(b=1, s=8192, h=64, p=64, n=64)),
}


def cdiv(a, b):
    return -(-a // b)


def pairs(b, h, s, causal, tile=64):
    """(query, key) pairs the attention kernels' tiles walk: whole 64 x 64
    tiles, those above the diagonal skipped under ``causal``."""
    n = cdiv(s, tile)
    return b * h * tile * tile * (n * (n + 1) // 2 if causal else n * n)


def closed_forms(name: str) -> dict:
    """{instance prefix: (unique bytes, FLOPs)} of a case's launches."""
    kind, p = SHAPES[name]
    if kind in ("attn", "bwd"):
        b, s, h, kvh, d, dv = (p[k] for k in ("b", "s", "h", "kvh", "d", "dv"))
        e = 2 if p["dt"] == BF16 else 4
        q, o, kv = b * s * h * d, b * s * h * dv, b * s * kvh * (d + dv)
        rows = 4 * b * s * h                       # one fp32 a (row, head): lse, delta
        n = pairs(b, h, s, p["causal"])
        if kind == "attn":
            return {"attn_fwd": (e * (q + kv + o) + rows, 2 * (d + dv) * n)}
        return {"attn_bwd_dq": (e * (q + o + kv + q) + 2 * rows, 2 * (2 * d + dv) * n),
                "attn_bwd_dkv": (e * (q + o + 2 * kv) + 2 * rows, 4 * (d + dv) * n)}
    if kind == "decode":
        b, s, h, kvh, d, kv_len = (p[k] for k in ("b", "s", "h", "kvh", "d", "kv_len"))
        tiles = cdiv(kv_len, 32)
        # the bound column reads kv_len rows; the kernel reads whole 32-key tiles
        live = min(s, tiles * 32)
        out = b * h * d * (4 if p.get("partial") else 2) + (4 * b * h if p.get("partial") else 0)
        frags = cdiv(h // kvh, 16)
        return {"flash_decode": (2 * (b * h * d + 2 * b * live * kvh * d) + out,
                                 b * kvh * frags * tiles * 2 * 16 * 32 * 2 * d)}
    if kind == "ffn":
        t, d, f, dt = p["t"], p["d"], p["f"], p["dt"]
        e, fp = (2 if dt == BF16 else 4), cdiv(f, 64) * 64
        route, _ = k4.ffn_plan(t, f, dt)
        if route == "tiled":
            # pass A writes h (t rounded to 128-row tiles, F to 64 columns) and
            # pass B reads it: beside the bound's inputs and output, h twice
            tp = cdiv(t, 128) * 128
            return {"ffn_gate_up": (e * (t * d + 2 * d * f + tp * fp), 4 * tp * d * fp),
                    "ffn_down": (e * (tp * fp + f * d + t * d), 2 * tp * d * fp)}
        splits, _ = k4.split_plan(t, f)
        part = 4 * splits * t * d                  # the fp32 partials, written and read
        return {"ffn_": (e * (t * d + 3 * d * f) + part, 6 * cdiv(t, 16) * 16 * d * fp),
                "ffn_combine": (part + e * t * d, 0)}
    b, s, h, pp, n = (p[k] for k in ("b", "s", "h", "p", "n"))
    chunks = cdiv(s, 64)
    flops = b * h * chunks * 2 * 64 * (64 * n + 64 * pp + 2 * n * pp)
    flops += b * h * chunks * 2 * 64 * n * pp       # the mma route's lo term
    return {"ssd_chunk_scan": (2 * (2 * b * s * h * pp + 2 * b * s * n)
                               + 4 * (b * s * h + h + b * h * pp * n), flops)}


@pytest.fixture(scope="module")
def all_facts():
    return {name: catalog.trace_case(name) for name in catalog.case_names()}


# --- the catalog ------------------------------------------------------------------

def test_catalog_carries_the_reference_case_names():
    assert list(catalog.REFERENCE_CASES) == reference_catalog.case_names()
    assert catalog.case_names()[:8] == reference_catalog.case_names()
    assert sorted(catalog.case_names()) == sorted(SHAPES)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_streams_equal_the_closed_forms(name, all_facts):
    """Each launch's stream: unique-tile bytes are each of its inputs and
    outputs once (stated differences: K3 reads whole 32-key tiles past
    kv_len, K4's h and its fp32 partials are written by one pass and read by
    the next), FLOPs the tile-granular products; one Op a block."""
    want = closed_forms(name)
    got = {}
    for fct in all_facts[name]:
        trace = streams.compile_trace(fct, name)
        assert len(trace.ops) == fct.n_blocks
        key = max((k for k in want if fct.instance.startswith(k)), key=len)
        got[key] = (trace.footprint_bytes(), trace.total_flops)
    assert got == want


def test_split_launches_sum_to_the_bound_bytes(all_facts):
    """K4's tiled passes together read the bound column's bytes (x, the three
    weights, y once) and h twice."""
    t, d, f = 2048, 2048, 8192
    total = sum(streams.compile_trace(fct, "t2048").footprint_bytes()
                for fct in all_facts["fused_ffn.t2048"])
    assert total == 2 * (2 * t * d + 3 * d * f) + 2 * 2 * t * f


def test_facts_are_the_plans(all_facts):
    """Grids, clusters and tiles come from the wrappers' plans."""
    k1f, = all_facts["flash_attention.train"]
    assert k1f.grid == (4 * 32, 16, 1) and k1f.threads == 128 and k1f.cluster == 1
    dq, dkv = all_facts["flash_attention_bwd.train"]
    plan = k2.bwd_plan(4, 1024, 1024, 32, 4, 64, BF16, True)
    assert (dq.grid, dkv.grid, dkv.cluster) == (plan.dq_grid, plan.dkv_grid, plan.cluster)
    assert dkv.instance == "attn_bwd_dkv_mma<64,64,64>" and dkv.cluster == 8
    dec, = all_facts["flash_decode.serve"]
    plan = k3.decode_plan(4, 4, 8, 1024, 64, BF16)
    assert (dec.grid, dec.cluster) == (plan.grid, plan.cluster)
    assert [f.launches for f in all_facts["fused_ffn.t2048"]] == [2, 2]   # two row chunks of h
    assert [f.instance for f in all_facts["fused_ffn.t4"]] == ["ffn_mma",
                                                               "ffn_combine<__nv_bfloat16>"]
    assert all_facts["ssd_scan.prefill"][0].instance == "ssd_chunk_scan_mma<64,64>"
    assert all_facts["flash_decode.partial"][0].entry == "flash_decode_partial_fwd"
    for fcts in all_facts.values():
        for fct in fcts:
            line = (ROOT / fct.src_file).read_text().splitlines()[fct.src_line - 1]
            assert re.match(rf"\s*{fct.instance.split('<')[0]}\(", line), (fct.instance, line)


def test_decode_cluster_from_the_card_is_used():
    """The card's cluster (``launch_plan``'s, passed in as a number) sets
    K3's grid; the facts stay clean."""
    fct, = catalog.trace_case("flash_decode.serve", lambda *a: 5)
    assert fct.cluster == 5 and fct.grid == (4 * 4 * 1 * 5, 1, 1)
    assert run_rules(fct) == []


# --- the rules --------------------------------------------------------------------

def test_shipped_kernels_have_no_findings(all_facts):
    facts = [f for fcts in all_facts.values() for f in fcts]
    assert run_rules(facts) == []
    assert run_rules(facts, waivers=False) == []


def test_no_waiver_in_the_sources():
    for cu in sorted(CSRC.glob("*.cu*")):
        assert "check: waive" not in cu.read_text(), cu


def one(name):
    return catalog.trace_case(name)[0]


def fired(facts, rule, **kw) -> Finding:
    found = [f for f in run_rules(facts, rules=[rule], **kw) if f.rule == rule]
    assert found, rule
    f = found[0]
    assert (f.file, f.line) == (facts.src_file, facts.src_line)
    assert f.format().startswith(f"{facts.src_file}:{facts.src_line}: {rule} ")
    return f


def test_r1_fires_on_a_tile_off_the_mma_grid():
    fct = one("flash_attention.serve")
    bad = dataclasses.replace(fct, products=(F.Product("S = Q K^T", 24, 64, 64,
                                                       (512, 512, 64)),))
    assert "m 24 is no multiple of 16" in fired(bad, "R1").message
    # a tile that covers the whole dim is fine
    whole = dataclasses.replace(fct, products=(F.Product("S = Q K^T", 24, 64, 64,
                                                         (24, 512, 64)),))
    assert run_rules(whole, rules=["R1"]) == []


def test_r2_fires_on_an_output_left_unwritten():
    fct = one("flash_attention.serve")
    out = fct.walk("out")
    keep = out.block != out.block.max()
    short = dataclasses.replace(out, block=out.block[keep], start=out.start[keep],
                                stop=out.stop[keep], masked=out.masked[keep])
    bad = dataclasses.replace(fct, walks=tuple(short if w is out else w for w in fct.walks))
    assert "never written" in fired(bad, "R2").message


def test_r2_fires_on_a_ragged_tile_left_unmasked():
    fct = one("fused_ffn.t4")
    x = fct.walk("x")
    bad = dataclasses.replace(fct, walks=tuple(
        dataclasses.replace(w, masked=np.zeros_like(w.masked)) if w is x else w
        for w in fct.walks))
    assert "passes the tensor's end" in fired(bad, "R2").message


def test_r2_fires_on_a_mask_the_geometry_does_not_ask_for():
    fct = one("flash_attention.train")
    k = fct.walk("k")
    bad = dataclasses.replace(fct, walks=tuple(
        dataclasses.replace(w, masked=np.ones_like(w.masked)) if w is k else w
        for w in fct.walks))
    assert "nothing asks" in fired(bad, "R2").message


def test_r2_fires_on_a_tile_outside_its_tensor():
    fct = one("ssd_scan.prefill")
    x = fct.walk("x")
    start = x.start.copy()
    start[-1, 1] += 512
    bad = dataclasses.replace(fct, walks=tuple(
        dataclasses.replace(w, start=start, stop=start + (x.stop - x.start)) if w is x else w
        for w in fct.walks))
    assert "outside" in fired(bad, "R2").message


def test_r2_fires_on_k3s_rank_warp_split(monkeypatch):
    """A walk that forgets the warp's offset: every warp of a rank visits the
    same tiles, so the cluster visits some twice and misses others."""
    def no_warp(plan, rank, warp, kv_len):
        t = plan.tile
        return [(n0, n0 + t > kv_len)
                for n0 in range(rank * t, kv_len, plan.cluster * plan.warps * t)]

    monkeypatch.setattr(k3, "decode_walk", no_warp)
    fct = one("flash_decode.serve")
    assert any("visited twice" in f.message for f in run_rules(fct, rules=["R2"]))
    fired(fct, "R2")


def test_r2_fires_on_k2bs_cluster_rows_with_a_gap(monkeypatch):
    monkeypatch.setattr(k2, "cluster_rows",
                        lambda c, rows=k2.DKV_KEYS: [(r * rows // c, (r + 1) * rows // c - 1)
                                                     for r in range(c)])
    _, dkv = catalog.trace_case("flash_attention_bwd.train")
    assert "never written" in fired(dkv, "R2").message


def test_r2_fires_on_k2bs_heads_split_unevenly(monkeypatch):
    """A cluster whose ranks all walk the group's first heads covers those
    heads' q-tiles once a rank and misses the others."""
    monkeypatch.setattr(k2, "dkv_heads", lambda plan, kvh, g, rank: [
        kvh * g + j for j in range(plan.heads_per_block)])
    _, dkv = catalog.trace_case("flash_attention_bwd.train")
    messages = [f.message for f in run_rules(dkv, rules=["R2"])]
    assert any("q: the split walk" in m and "visited twice" in m for m in messages), messages
    assert any("q: the split walk" in m and "missed" in m for m in messages), messages
    fired(dkv, "R2")


def test_r3_fires_on_two_blocks_writing_one_tile(monkeypatch):
    """K2b's cluster ranks each writing the whole key tile: no merge shares."""
    monkeypatch.setattr(k2, "cluster_rows", lambda c, rows=k2.DKV_KEYS: [(0, rows)] * c)
    _, dkv = catalog.trace_case("flash_attention_bwd.train")
    assert "written by 8 blocks" in fired(dkv, "R3").message


def test_r4_fires_on_a_bf16_accumulator_and_on_tf32():
    fct = one("flash_attention.serve")
    assert "accumulate in bfloat16" in fired(dataclasses.replace(fct, acc_dtype="bfloat16"),
                                             "R4").message
    fp32 = one("flash_attention.b1s1024f32")
    assert fp32.mma is None and fp32.dtype == "float32"
    assert "TF32" in fired(dataclasses.replace(fp32, mma="m16n8k8"), "R4").message


def test_r5_fires_on_shared_memory_and_on_the_ptxas_report():
    fct = one("flash_attention.mla")
    assert fct.smem == 111_616                    # flash_attention.cu's own figure
    assert "dynamic shared memory" in fired(dataclasses.replace(fct, smem=228 * 1024),
                                            "R5").message
    ok = {fct.instance: {"registers": 244, "spill_stores": 0, "spill_loads": 0}}
    assert run_rules(fct, rules=["R5"], ptxas=ok) == []
    spill = {fct.instance: {"registers": 255, "spill_stores": 28, "spill_loads": 28}}
    assert "spills" in fired(fct, "R5", ptxas=spill).message
    regs = {fct.instance: {"registers": 256, "spill_stores": 0, "spill_loads": 0}}
    assert "registers" in fired(fct, "R5", ptxas=regs).message
    assert "not in the build" in fired(fct, "R5", ptxas={}).message
    fp32 = one("flash_attention.b1s1024f32")          # fp32 instances: reported, not held
    assert run_rules(fp32, rules=["R5"], ptxas={}) == []


def test_coverage_counts_boxes_exactly():
    start = np.array([[0, 0], [0, 4], [2, 0]])
    stop = np.array([[2, 4], [2, 8], [4, 6]])
    count = coverage(start, stop, limit=(4, 8))
    assert count.min() == 0 and count.max() == 1       # [2:4, 6:8] unwritten
    twice = coverage(np.vstack([start, [[1, 1]]]), np.vstack([stop, [[3, 3]]]), limit=(4, 8))
    assert twice.max() == 2
    groups = coverage(np.array([[0], [2], [0]]), np.array([[2], [4], [4]]), np.array([0, 0, 1]),
                      np.array([[0], [0]]), np.array([[4], [3]]))
    assert (groups == 1).all()


# --- waivers ----------------------------------------------------------------------

def test_a_waiver_needs_a_reason(tmp_path):
    cu = tmp_path / "k.cu"
    cu.write_text("// check: waive[R3] the partial sums go through a combine pass\n"
                  "__global__ void __launch_bounds__(128)\nkernel_a(int x) {}\n"
                  "// check: waive[R3]\n__global__ void kernel_b(int x) {}\n"
                  "// check: waive[R1,R5] the tile covers the whole dim\n"
                  "__global__ void kernel_c(int x) {}\n")
    found = [Finding(rule, "k", "c", str(cu), line, "m")
             for rule, line in (("R3", 3), ("R3", 5), ("R5", 7), ("R2", 7))]
    assert [f.waived for f in apply_waivers(found)] == [True, False, True, False]


# --- the constants that live only in the CUDA source ------------------------------

def constant(cu: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / cu).read_text()).group(1))


def test_c_tiles_match_the_cuda_source():
    for name, value in F.K4_TILED.items():
        assert constant("fused_ffn.cu", name) == value, name
    for name, value in F.K4_ROWTILE.items():
        assert constant("fused_ffn.cu", name) == value, name
    assert (constant("ssd_scan.cu", "L"), constant("ssd_scan.cu", "THREADS")) == (
        F.K5_CHUNK, F.K5_FMA_THREADS)
    assert "ssd_chunk_scan<T, P><<<B * H, THREADS, smem" in (CSRC / "ssd_scan.cu").read_text()
    assert "ssd_chunk_scan_mma<P, N><<<B * H, MMA_THREADS" in (CSRC / "ssd_scan.cu").read_text()
    assert F.K5_CHUNK == k5.CHUNK
    # K4's two rings, as the source's comments give them
    text = (CSRC / "fused_ffn.cu").read_text()
    gu, dn = F.k4_tiled_smem()
    assert f"// {gu:,} bytes" in text and f"// {dn:,} bytes" in text
    assert "smem_fma(int D) {\n  return ((size_t)BM * D + (size_t)BM * BF) * sizeof(float);" in text
    # K3
    for name, value in (("WARPS", k3.WARPS), ("ROWS", k3.ROWS), ("STAGES", F.K3_STAGES),
                        ("KEYS", k3.TILE_KEYS), ("MAX_CLUSTER", k3.MAX_CLUSTER)):
        assert constant("flash_decode.cu", name) == value, name
    text = (CSRC / "flash_decode.cu").read_text()
    assert "return STAGES * 2 * KEYS * (D + 8) * (int)sizeof(__nv_bfloat16);" in text
    assert "return (size_t)WARPS * mma_warp_bytes<D>() + part_floats<D>() * sizeof(float);" in text
    assert "return (size_t)(ROWS * D + (WARPS + 1) * part_floats<D>()) * sizeof(float);" in text
    # K2's tiles and shared memory (``facts._dq_smem``, ``_dkv_smem``)
    for name, value in (("DQ_BM", k2.DQ_ROWS), ("BN", k2.DKV_KEYS), ("FT", k2.FMA_TILE),
                        ("DKV_STAGES", 3), ("THREADS", 128)):
        assert constant("flash_attention_bwd.cu", name) == value, name
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for line in ("dq_stages() { return D == 128 ? 2 : 3; }",
                 "return (size_t)(DQ_BM + dq_stages<D>() * BNQ) * (D + 8 + DV + 8) * "
                 "sizeof(__nv_bfloat16);",
                 "constexpr size_t tiles = (size_t)(BN + DKV_STAGES * BM) * (D + 8 + DV + 8) * "
                 "sizeof(__nv_bfloat16)\n                           + (size_t)DKV_STAGES * 2 * BM "
                 "* sizeof(float);",
                 "constexpr size_t partials = (size_t)BN * (D + 8 + DV + 8) * sizeof(float);",
                 "return (size_t)(2 * FT * (D + 1) + 2 * FT * (DV + 1) + FT * (FT + 1) + 2 * FT) "
                 "* sizeof(float);",
                 "return (size_t)(2 * FT * (D + 1) + 2 * FT * (DV + 1) + 2 * FT * (FT + 1) + 2 * FT)"
                 " *\n         sizeof(float);"):
        assert line in text, line


def test_mma_instruction_is_read_from_the_source():
    for cu in ("flash_attention.cu", "flash_attention_bwd.cu", "flash_decode.cu", "ssd_scan.cu",
               "fused_ffn.cu"):
        assert F.mma_of(cu) == ("m16n8k16", "bfloat16", "float32"), cu


# --- the ptxas report -------------------------------------------------------------

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112attn_fwd_mmaILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112attn_fwd_mmaILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114ssd_chunk_scanI13__nv_bfloat16Li64EEEvPKT_PKfS6_S4_S4_PS2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114ssd_chunk_scanI13__nv_bfloat16Li64EEEvPKT_PKfS6_S4_S4_PS2_Pfiii
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111ffn_combineIfEEvPKfPT_mi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111ffn_combineIfEEvPKfPT_mi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, 380 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_decode_mmaILi64ELb1EEEvPK13__nv_bfloat16S3_S3_PvPfPKiiiiif' for 'sm_90a'
ptxas info    : Used 124 registers, 404 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_17ffn_mmaEPK13__nv_bfloat16S2_S2_S2_PS0_Pfiiii' for 'sm_90a'
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_17ffn_mmaEPK13__nv_bfloat16S2_S2_S2_PS0_Pfiiii' for 'sm_90a'
ptxas info    : Used 130 registers
"""


def test_ptxas_report_parses_its_format():
    rep = ptxas.ptxas_report(PTXAS_LOG)
    assert rep == {
        "attn_fwd_mma<64,64>": {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        "ssd_chunk_scan<__nv_bfloat16,64>": {"registers": 255, "spill_stores": 8,
                                             "spill_loads": 12},
        # a callee's spills are not the entry's
        "ffn_combine<float>": {"registers": 16, "spill_stores": 0, "spill_loads": 0},
        "flash_decode_mma<64,1>": {"registers": 124},
        "ffn_mma": {"registers": 128}, "ffn_mma#2": {"registers": 130}}
    fct = one("flash_attention.serve")
    assert run_rules(fct, rules=["R5"], ptxas=rep) == []


def test_chip_smoke_reads_the_report_from_the_package():
    text = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.check.ptxas import ptxas_report" in text
    assert "def ptxas_report" not in text and "def kernel_name" not in text


# --- the CLI ----------------------------------------------------------------------

def test_cli_exits_zero_on_the_shipped_kernels(capsys):
    assert cli.main(["--cases", "flash_attention.serve,fused_ffn,ssd_scan.b2s1024"]) == 0
    out = capsys.readouterr().out
    n = len(catalog.trace_all([c for c in catalog.case_names() if c.startswith(
        ("flash_attention.serve", "fused_ffn", "ssd_scan.b2s1024"))]))
    assert f"repro_torch.check: {n} kernel launch plan(s) across 7 case(s): 0 finding(s)" in out


def test_cli_list_json_rules_and_waiver_flags(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in catalog.case_names()) and "R5" in out
    assert cli.main(["--json", "--rules", "R1,R4", "--cases", "flash_decode.32k",
                     "--no-waivers", "--show-waived"]) == 0
    assert json.loads(capsys.readouterr().out) == []
    assert cli.main(["--cases", "no_such_case"]) == 2


def test_cli_exit_code_counts_unwaived_findings(monkeypatch, capsys):
    monkeypatch.setattr(k2, "cluster_rows", lambda c, rows=k2.DKV_KEYS: [(0, rows)] * c)
    code = cli.main(["--cases", "flash_attention_bwd.b2s512", "--rules", "R3"])
    out = capsys.readouterr().out
    assert code == 2 and out.count(" R3 [attn_bwd_dkv_mma<128,128,32> @ b2s512]") == 2, out


# --- the copied trace IR ----------------------------------------------------------

def test_trace_is_the_references_copy():
    ours = (ROOT / "src" / "repro_torch" / "core" / "trace.py").read_text()
    assert ours == (ROOT / "src" / "repro" / "core" / "trace.py").read_text()
    trace = streams.compile_trace(one("ssd_scan.b2s1024"), "ssd")
    assert trace.peak_live_bytes() > 0 and math.isfinite(trace.total_flops)
