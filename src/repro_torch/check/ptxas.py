"""``ptxas -v``'s report of the built kernels: registers and spill bytes of
each kernel instance, read from ``nvcc -Xptxas -v``'s output
(``kernels.build.build(verbose=True)`` prints it).

Instances are named by their template arguments, integers and types alike:
``attn_bwd_dkv_mma<128,128,32>``, ``flash_decode_mma<64,0>``,
``ssd_chunk_scan<__nv_bfloat16,64>``, ``ffn_combine<float>``; where two
entries still share a name, the n-th gets "#n". ``chip_smoke.py``'s
``build`` line and ``check.rules``' R5 read it.
"""
from __future__ import annotations

import re

# one-letter codes of the Itanium ABI's builtin types
_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned", "b": "bool",
            "l": "long", "m": "unsigned long", "h": "unsigned char", "c": "char"}


def _template_args(mangled: str, pos: int) -> list[str] | None:
    """The arguments of the template argument list ``I ... E`` at ``pos``:
    literals (``Li64E`` -> "64"), source names (``13__nv_bfloat16``) and
    builtin types (``f`` -> "float"); None where it is none of these."""
    if not mangled.startswith("I", pos):
        return None
    pos += 1
    args = []
    while pos < len(mangled) and mangled[pos] != "E":
        if m := re.match(r"L[a-z]+(-?\d+)E", mangled[pos:]):
            args.append(m.group(1))
        elif m := re.match(r"(\d+)", mangled[pos:]):
            n = int(m.group(1))
            args.append(mangled[pos + m.end():pos + m.end() + n])
            pos += n
        elif mangled[pos] in _BUILTIN:
            args.append(_BUILTIN[mangled[pos]])
            pos += 1
            continue
        else:
            return None
        pos += m.end()
    return args


def kernel_name(mangled: str) -> str:
    """The unqualified name in an Itanium-mangled function name:
    ``_ZN<len><namespace><len><name>...`` or ``_Z<len><name>...``, with a
    template's arguments as ``name<64,...>``."""
    m = re.match(r"_Z(N?)", mangled)
    if not m:
        return mangled
    pos, names = m.end(), []
    while n := re.match(r"\d+", mangled[pos:]):
        pos += n.end()
        names.append(mangled[pos:pos + int(n.group())])
        pos += int(n.group())
        if not m.group(1):
            break
    if not names:
        return mangled
    args = _template_args(mangled, pos)
    return names[-1] if not args else names[-1] + "<" + ",".join(args) + ">"


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel from ``nvcc -Xptxas -v``'s
    output, by ``kernel_name``: ``{name: {"registers": n, "spill_stores": n,
    "spill_loads": n}}``."""
    report, entry, name = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m.group(1)
            name = base = kernel_name(entry)
            n = 1
            while name in report:
                n += 1
                name = f"{base}#{n}"
            report[name] = {}
        elif m := re.search(r"Function properties for (\w+)", line):
            if m.group(1) != entry:
                name = None          # a callee's properties, not the entry's
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
    return report
