"""``python -m repro_torch.check`` — lint the port's Hopper kernels statically,
from their launch plans, on any machine (no card, no ``nvcc``).

Exit code = the number of unwaived findings (0: clean). Findings print as
``file:line: RULE [instance @ case] message``; ``--json`` prints a list.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.check import catalog
from repro_torch.check.rules import RULE_DESCRIPTIONS, RULES, run_rules


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static analyser for the CUDA kernels in src/repro_torch/csrc/ "
                    "(rules R1-R5 for sm_90a).")
    p.add_argument("--rules", default=None,
                   help=f"comma-separated subset, e.g. --rules R1,R3 (default: all of "
                        f"{','.join(RULES)})")
    p.add_argument("--cases", default=None,
                   help="comma-separated catalog cases or prefixes (see --list)")
    p.add_argument("--json", action="store_true", dest="as_json", help="print findings as JSON")
    p.add_argument("--list", action="store_true", dest="list_cases",
                   help="list catalog cases and rules, then exit")
    p.add_argument("--no-waivers", action="store_true",
                   help="ignore '// check: waive[...]' comments")
    p.add_argument("--show-waived", action="store_true", help="also print waived findings")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_cases:
        print("cases:")
        for name in catalog.case_names():
            print(f"  {name}")
        print("rules:")
        for rule in RULES:
            print(f"  {rule}  {RULE_DESCRIPTIONS[rule]}")
        return 0
    rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()] if args.rules else None
    names = catalog.case_names()
    if args.cases:
        wanted = [c.strip() for c in args.cases.split(",") if c.strip()]
        names = [n for n in names if any(w == n or n.startswith(w) for w in wanted)]
        if not names:
            print(f"no catalog case matches {wanted}", file=sys.stderr)
            return 2
    facts = catalog.trace_all(names)
    findings = run_rules(facts, rules=rules, waivers=not args.no_waivers)
    unwaived = [f for f in findings if not f.waived]
    shown = findings if args.show_waived else unwaived
    if args.as_json:
        print(json.dumps([dataclasses.asdict(f) for f in shown], indent=2))
    else:
        for f in shown:
            print(f.format())
        waived = len(findings) - len(unwaived)
        print(f"repro_torch.check: {len(facts)} kernel launch plan(s) across {len(names)} "
              f"case(s): {len(unwaived)} finding(s)" + (f", {waived} waived" if waived else ""))
    return len(unwaived)


if __name__ == "__main__":
    sys.exit(main())
