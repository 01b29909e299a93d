"""Rule engine over ``KernelFacts``: R1-R5 for ``sm_90a`` on
``core.hw.H100_SXM``, and waivers in the CUDA sources.

  R1  tile alignment   — each product's tile extents are multiples of the
                         MMA instruction's (m16n8k16 for bf16), or cover
                         the whole dim.
  R2  coverage, bounds — every walked tile starts inside its tensor, a tile
                         that passes the tensor's end is masked, and a
                         kernel that masks per tile masks exactly where the
                         geometry asks (the ragged tile, the causal
                         diagonal, keys past kv_len); every output element
                         is written; a split walk (K2b's cluster over its
                         heads, ``cluster_rows``; K3's ranks x warps over
                         the live tiles) covers its region exactly once.
  R3  write hazard     — no output element is written by two blocks. A
                         cluster's merge writes each rank's own share, and
                         a combine pass (``ffn_combine``) reads partials
                         that each block wrote to its own slice, so both
                         pass where their shares are disjoint.
  R4  accumulator      — bf16 products accumulate in fp32; fp32 takes IEEE
                         FMAs, not a tensor-core instruction (TF32).
  R5  footprint        — dynamic shared memory at most 227 KB a block
                         (``core.hw.H100_SXM``'s opt-in limit); given a
                         ``ptxas`` report (``check.ptxas``), at most 255
                         registers and no spill on the bf16 instances.

Waivers: a ``// check: waive[R3] <reason>`` comment (or ``waive[R1,R5]``)
in a ``.cu`` source waives those rules' findings on the kernel defined next
below it. A waiver needs a reason: one without waives nothing.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np

from repro_torch.check.facts import ROOT, KernelFacts, Walk
from repro_torch.core.hw import H100_SXM

RULES = ("R1", "R2", "R3", "R4", "R5")

RULE_DESCRIPTIONS = {
    "R1": "tile extents vs the MMA instruction's tile",
    "R2": "grid coverage, tile bounds and masks",
    "R3": "output elements written by two blocks",
    "R4": "fp32 accumulation of bf16 products; IEEE FMAs for fp32",
    "R5": "shared memory a block; registers and spills (ptxas)",
}

SMEM_PER_BLOCK = 227 * 1024     # an H100 block's opt-in dynamic shared memory
MAX_REGISTERS = 255
_MMA_TILE = re.compile(r"m(\d+)n(\d+)k(\d+)")


@dataclass(frozen=True)
class Finding:
    rule: str
    kernel: str
    case: str
    file: str
    line: int
    message: str
    waived: bool = False

    def format(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.file}:{self.line}: {self.rule} [{self.kernel} @ {self.case}]{tag} {self.message}"


def _finding(facts: KernelFacts, rule: str, message: str) -> Finding:
    return Finding(rule, facts.instance, facts.case, facts.src_file, facts.src_line, message)


# --- coverage --------------------------------------------------------------------

def coverage(start, stop, group=None, lo=None, hi=None, limit=None) -> np.ndarray:
    """How many boxes [start, stop) cover each cell of each group's region
    [lo[g], hi[g]), the boxes clipped to the region and to ``limit`` (a
    tensor's shape): an array with a leading group dim over the cells of
    the boxes' coordinate compression, every cell inside a region (where
    the regions differ in extent, a cell past a group's region counts 0 for
    both). With no groups, one group: the whole of ``limit``. NumPy
    throughout: a difference array over the compressed grid, summed."""
    start, stop = np.asarray(start, np.int64), np.asarray(stop, np.int64)
    n, nd = start.shape
    if group is None:
        group = np.zeros(n, np.int64)
        lo, hi = np.zeros((1, nd), np.int64), np.asarray(limit, np.int64)[None]
    ng = len(lo)
    if limit is not None:
        hi = np.minimum(hi, np.asarray(limit, np.int64))
    # coordinates relative to the group's region, clipped to it
    s = np.clip(start - lo[group], 0, None)
    e = np.minimum(stop, hi[group]) - lo[group]
    keep = (e > s).all(axis=1)
    s, e, grp = s[keep], e[keep], group[keep]
    ext = np.clip(hi - lo, 0, None)
    cuts = [np.unique(np.concatenate([s[:, k], e[:, k], [0], ext[:, k]])) for k in range(nd)]
    shape = (ng,) + tuple(len(c) for c in cuts)     # one extra cell a dim: the difference's end
    diff = np.zeros(int(np.prod(shape)), np.int64)
    lo_i = [np.searchsorted(c, s[:, k]) for k, c in enumerate(cuts)]
    hi_i = [np.searchsorted(c, e[:, k]) for k, c in enumerate(cuts)]
    strides = np.cumprod((1,) + shape[::-1])[::-1][1:]
    for corner in range(1 << nd):
        idx = grp * strides[0]
        sign = np.ones(len(grp), np.int64)
        for k in range(nd):
            if corner >> k & 1:
                idx = idx + hi_i[k] * strides[k + 1]
                sign = -sign
            else:
                idx = idx + lo_i[k] * strides[k + 1]
        diff += np.bincount(idx, weights=sign, minlength=len(diff)).astype(np.int64)
    count = diff.reshape(shape)
    for k in range(1, nd + 1):
        count = np.cumsum(count, axis=k)
    count = count[(slice(None),) + (slice(0, -1),) * nd]
    # cells inside each group's own region
    inside = np.ones(count.shape, bool)
    for k, c in enumerate(cuts):
        mid = c[:-1]
        view = [1] * (nd + 1)
        view[0], view[k + 1] = ng, len(mid)
        inside &= (mid[None, :] < ext[:, k][:, None]).reshape(view)
    return np.where(inside, count, 1)


# --- R1: tile alignment ----------------------------------------------------------

def _check_tiles(facts: KernelFacts) -> list[Finding]:
    if facts.mma is None:
        return []
    tile = tuple(int(x) for x in _MMA_TILE.fullmatch(facts.mma).groups())
    out = []
    for p in facts.products:
        bad = [f"{axis} {got} is no multiple of {want}"
               for axis, got, want, full in zip("mnk", (p.m, p.n, p.k), tile, p.dims)
               if got % want and got < full]
        if bad:
            out.append(_finding(facts, "R1", f"{p.name} tile ({p.m}, {p.n}, {p.k}) against "
                                             f"{facts.mma}: " + "; ".join(bad)))
    return out


# --- R2: coverage, bounds, masks -------------------------------------------------

def _check_walk_bounds(facts: KernelFacts, w: Walk) -> list[Finding]:
    out = []
    shape = np.asarray(w.shape)
    outside = ((w.start < 0) | (w.start >= shape) | (w.stop <= w.start)).any(axis=1)
    if outside.any():
        i = int(np.flatnonzero(outside)[0])
        out.append(_finding(facts, "R2", f"{w.tensor}: block {int(w.block[i])} walks tile "
                                         f"{_box(w, i)} outside {w.shape}"))
    ragged = w.ragged()
    need = ragged | (w.needed if w.needed is not None else False)
    missing = need & ~w.masked
    if missing.any():
        i = int(np.flatnonzero(missing)[0])
        why = "passes the tensor's end" if ragged[i] else "needs a mask"
        out.append(_finding(facts, "R2", f"{w.tensor}: tile {_box(w, i)} of block "
                                         f"{int(w.block[i])} {why} and is not masked "
                                         f"({int(missing.sum())} such visits)"))
    if w.exact:
        extra = w.masked & ~need
        if extra.any():
            i = int(np.flatnonzero(extra)[0])
            out.append(_finding(facts, "R2", f"{w.tensor}: tile {_box(w, i)} of block "
                                             f"{int(w.block[i])} is masked where nothing asks "
                                             f"for it ({int(extra.sum())} such visits)"))
    return out


def _box(w: Walk, i: int) -> str:
    return "[" + ", ".join(f"{a}:{b}" for a, b in zip(w.start[i], w.stop[i])) + ")"


def _check_coverage(facts: KernelFacts) -> list[Finding]:
    out = []
    for w in facts.walks:
        out += _check_walk_bounds(facts, w)
        if w.role == "out":
            count = coverage(w.start, w.stop, limit=w.shape)
            if (count == 0).any():
                out.append(_finding(facts, "R2", f"{w.tensor}: {int((count == 0).sum())} "
                                                 f"region(s) of {w.shape} never written"))
        if w.group is not None:
            lo, hi = (r[w.group] for r in w.region)
            away = ~(np.minimum(w.stop, hi) > np.maximum(w.start, lo)).all(axis=1)
            if away.any():
                i = int(np.flatnonzero(away)[0])
                out.append(_finding(facts, "R2", f"{w.tensor}: block {int(w.block[i])} walks tile "
                                                 f"{_box(w, i)} outside its group's region "
                                                 f"({int(away.sum())} such visits)"))
            count = coverage(w.start, w.stop, w.group, *w.region, limit=w.shape)
            for bad, what in ((count == 0, "missed"), (count > 1, "visited twice")):
                if bad.any():
                    g = int(np.flatnonzero(bad.any(axis=tuple(range(1, bad.ndim))))[0])
                    out.append(_finding(facts, "R2", f"{w.tensor}: the split walk of group {g} "
                                                     f"leaves tiles of its region {what}"))
    return out


# --- R3: write hazard ------------------------------------------------------------

def _check_write_hazard(facts: KernelFacts) -> list[Finding]:
    out = []
    for w in facts.walks:
        if w.role != "out":
            continue
        count = coverage(w.start, w.stop, limit=w.shape)
        if (count > 1).any():
            out.append(_finding(facts, "R3", f"{w.tensor}: {int((count > 1).sum())} region(s) "
                                             f"of {w.shape} written by {int(count.max())} "
                                             f"blocks"))
    return out


# --- R4: accumulator -------------------------------------------------------------

def _check_accumulators(facts: KernelFacts) -> list[Finding]:
    if facts.acc_dtype != "float32":
        return [_finding(facts, "R4", f"{facts.dtype} products accumulate in {facts.acc_dtype}, "
                                      "not float32")]
    if facts.dtype == "float32" and facts.mma is not None:
        return [_finding(facts, "R4", f"fp32 products on a tensor-core instruction ({facts.mma}: "
                                      "TF32), not IEEE FMAs")]
    return []


# --- R5: footprint ---------------------------------------------------------------

def _check_footprint(facts: KernelFacts, ptxas: dict | None) -> list[Finding]:
    out = []
    if facts.smem > SMEM_PER_BLOCK:
        out.append(_finding(facts, "R5", f"{facts.smem} bytes of dynamic shared memory a block > "
                                         f"{SMEM_PER_BLOCK} ({H100_SXM.name})"))
    if ptxas is not None and facts.dtype == "bfloat16":
        rep = ptxas.get(facts.instance)
        if rep is None:
            out.append(_finding(facts, "R5", "not in the build's ptxas report"))
        else:
            if rep.get("registers", 0) > MAX_REGISTERS:
                out.append(_finding(facts, "R5", f"{rep['registers']} registers > "
                                                 f"{MAX_REGISTERS}"))
            spill = rep.get("spill_stores", 0) + rep.get("spill_loads", 0)
            if spill:
                out.append(_finding(facts, "R5", f"spills {rep.get('spill_stores', 0)} bytes "
                                                 f"stored, {rep.get('spill_loads', 0)} loaded"))
    return out


_RULE_FNS = {
    "R1": _check_tiles,
    "R2": _check_coverage,
    "R3": _check_write_hazard,
    "R4": _check_accumulators,
}


# --- waivers ---------------------------------------------------------------------

_WAIVE_RE = re.compile(r"//\s*check:\s*waive\[([A-Z0-9,\s]+)\](.*)")
_KERNEL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


@lru_cache(maxsize=256)
def waivers_for(path: str) -> tuple[tuple[tuple[str, ...], int], ...]:
    """((rules, kernel line), ...) of the waivers with a reason in ``path``
    (relative to the repo's root, or absolute): each waives its rules on the
    kernel whose name line is the first below the comment."""
    p = ROOT / path
    try:
        text = p.read_text()
    except OSError:
        return ()
    kernels = sorted(text.count("\n", 0, m.end(1)) + 1 for m in _KERNEL_RE.finditer(text))
    out = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _WAIVE_RE.search(line)
        if not m or not m.group(2).strip():
            continue
        below = [k for k in kernels if k > lineno]
        if below:
            out.append((tuple(r.strip() for r in m.group(1).split(",") if r.strip()), below[0]))
    return tuple(out)


def apply_waivers(findings: list[Finding]) -> list[Finding]:
    """Marks the findings a waiver in their source covers."""
    return [replace(f, waived=True)
            if any(f.rule in rules and f.line == line for rules, line in waivers_for(f.file))
            else f for f in findings]


# --- entry point -----------------------------------------------------------------

def run_rules(facts, rules=None, waivers: bool = True, ptxas: dict | None = None) -> list[Finding]:
    """The selected rules (default all) over one ``KernelFacts`` or a list;
    ``ptxas``: a ``check.ptxas.ptxas_report`` for R5's registers and
    spills."""
    if isinstance(facts, KernelFacts):
        facts = [facts]
    selected = list(rules) if rules else list(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rules {unknown}; known: {list(RULES)}")
    findings = []
    for f in facts:
        for rule in selected:
            findings += _check_footprint(f, ptxas) if rule == "R5" else _RULE_FNS[rule](f)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.case, f.message))
    return apply_waivers(findings) if waivers else findings
