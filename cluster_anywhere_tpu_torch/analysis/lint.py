"""`ca lint` front-end: run the analyzer, diff the baseline, render output.

Exit codes: 0 clean (or --update-baseline / --contract / --rules write/list
modes), 1 new findings or stale baseline entries, 2 usage errors.

  ca lint                      # all passes, friendly output, CI gate
  ca lint --format json        # machine-readable report
  ca lint --rules              # list every rule with its one-line rationale
  ca lint --changed            # findings only in files differing from the
                               # git merge-base (+ untracked) — the fast
                               # pre-push loop
  ca lint --update-baseline    # accept the current finding set
  ca lint --contract           # regenerate docs/PROTOCOL_CONTRACT_TORCH.json
                               # and its tables, docs/PROTOCOL_CONTRACT_TORCH.md
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from . import contract as contract_mod
from . import engine


def render_rules_markdown() -> str:
    """Markdown table of every rule across every pass."""
    lines = [
        "| pass | rule | what it catches |",
        "| --- | --- | --- |",
    ]
    rules = engine.all_rules()
    for pass_name in engine.ALL_PASSES:
        for rule in sorted(rules.get(pass_name, ())):
            desc = " ".join(rules[pass_name][rule].split())
            lines.append(f"| {pass_name} | `{rule}` | {desc} |")
    return "\n".join(lines)


def render_contract_markdown(extracted) -> str:
    """docs/PROTOCOL_CONTRACT_TORCH.md: the contract's table per handler
    surface and the rule table, the whole file generated."""
    return (
        "# RPC protocol contract of cluster_anywhere_tpu_torch (generated)\n\n"
        "Generated by `ca lint --contract` from the handlers and call sites "
        "of the package; do not edit. The machine-readable form is "
        "`docs/PROTOCOL_CONTRACT_TORCH.json`.\n\n"
        "## RPC methods by handler surface\n\n"
        + contract_mod.render_markdown(extracted)
        + "\n\n## Lint rules\n\n"
        "Every `ca lint` rule across every pass (`ca lint --rules` prints "
        "the same list).\n\n"
        + render_rules_markdown()
        + "\n"
    )


def write_contract(root: str, extracted) -> List[str]:
    """Write docs/PROTOCOL_CONTRACT_TORCH.json and its markdown tables,
    docs/PROTOCOL_CONTRACT_TORCH.md.  Returns the paths written."""
    path = os.path.join(root, *contract_mod.CONTRACT_JSON)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(contract_mod.contract_to_json(extracted), f, indent=1, sort_keys=True)
        f.write("\n")
    md = os.path.join(root, *contract_mod.CONTRACT_MD)
    with open(md, "w", encoding="utf-8") as f:
        f.write(render_contract_markdown(extracted))
    return [path, md]


def changed_files(root: str) -> Optional[Set[str]]:
    """Repo-relative paths differing from the merge-base with the upstream
    (or main) plus untracked files; None when git can't answer (not a git
    checkout, no base ref) — the caller falls back to a full run."""
    def git(*args) -> Optional[str]:
        try:
            out = subprocess.run(
                ("git", "-C", root) + args,
                capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        return out.stdout if out.returncode == 0 else None

    base = None
    for ref in ("@{upstream}", "origin/main", "origin/master", "main", "master"):
        if git("rev-parse", "--verify", "--quiet", ref) is not None:
            base = git("merge-base", "HEAD", ref)
            if base is not None:
                base = base.strip()
                break
    if base is None:
        return None
    diff = git("diff", "--name-only", base, "--")
    if diff is None:
        return None
    files = {line.strip() for line in diff.splitlines() if line.strip()}
    untracked = git("ls-files", "--others", "--exclude-standard") or ""
    files |= {line.strip() for line in untracked.splitlines() if line.strip()}
    return {f.replace(os.sep, "/") for f in files}


def _render_friendly(report: dict) -> str:
    lines = []
    counts = {}
    for f in report["findings"]:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    total = len(report["findings"])
    baselined = total - len(report["new"])
    lines.append(
        f"ca lint: {total} findings "
        f"({baselined} baselined, {len(report['new'])} new, "
        f"{report['suppressed']} pragma-suppressed, "
        f"{len(report['stale'])} stale baseline entries)"
    )
    for rule in sorted(counts):
        lines.append(f"  {rule:24s} {counts[rule]}")
    if report["new"]:
        lines.append("")
        lines.append("NEW findings (fix, pragma, or --update-baseline):")
        for f in report["new"]:
            lines.append("  " + f.render())
    if report["stale"]:
        lines.append("")
        lines.append(
            "STALE baseline entries (the finding no longer exists — run "
            "`ca lint --update-baseline` so the baseline only shrinks):"
        )
        for e in report["stale"]:
            lines.append(
                f"  [{e['rule']}] {e.get('file', '?')} {e.get('context', '')}"
                f" ({e['fingerprint']})"
            )
    if report["ok"]:
        lines.append("clean: no non-baselined findings.")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ca lint", description="AST-driven RPC contract checker, asyncio "
        "hazard analyzer, and CFG-dataflow deep passes: resource-lifetime "
        "leaks, unbounded network awaits, cancellation hygiene (see "
        "cluster_anywhere_tpu_torch/analysis/)."
    )
    p.add_argument("--root", default=None, help="repo root (default: auto)")
    p.add_argument(
        "--pass", dest="passes",
        choices=engine.ALL_PASSES + ("all",), default="all",
        help="run only one analysis pass",
    )
    p.add_argument(
        "--rules", action="store_true",
        help="list every rule across every pass with its rationale, then exit",
    )
    p.add_argument(
        "--changed", action="store_true",
        help="report findings only in files differing from the git "
        "merge-base (+ untracked) — fast pre-push loop; skips the "
        "stale-baseline gate",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (json for machines)",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="accept the current finding set as the new baseline",
    )
    p.add_argument(
        "--contract", action="store_true",
        help="regenerate docs/PROTOCOL_CONTRACT_TORCH.json and "
        "docs/PROTOCOL_CONTRACT_TORCH.md, then exit",
    )
    p.add_argument("--baseline", default=None, help="baseline file override")
    args = p.parse_args(argv)

    if args.changed and (args.update_baseline or args.contract):
        print(
            "ca lint: --changed filters the finding set and would write a "
            "partial baseline/contract; run --update-baseline/--contract "
            "without it", file=sys.stderr,
        )
        return 2

    if args.rules:
        rules = engine.all_rules()
        for pass_name in engine.ALL_PASSES:
            print(f"pass {pass_name}:")
            for rule in sorted(rules.get(pass_name, ())):
                desc = " ".join(rules[pass_name][rule].split())
                print(f"  {rule:24s} {desc}")
        return 0

    passes = engine.ALL_PASSES if args.passes == "all" else (args.passes,)
    try:
        report = engine.run_lint(
            root=args.root, passes=passes, baseline_file=args.baseline
        )
    except OSError as e:
        print(f"ca lint: cannot read tree: {e}", file=sys.stderr)
        return 2

    if args.changed:
        subset = changed_files(report["root"])
        if subset is None:
            print(
                "ca lint: --changed needs a git checkout with a base ref; "
                "running the full gate instead", file=sys.stderr,
            )
        else:
            # the whole tree was still ANALYZED (the RPC contract is
            # cross-file); only the reported finding set narrows.  Stale
            # baseline entries may live in unchanged files, so that gate is
            # deferred to the full run.
            report["findings"] = [f for f in report["findings"] if f.file in subset]
            report["new"] = [f for f in report["new"] if f.file in subset]
            report["stale"] = []
            report["ok"] = not report["new"]

    if args.contract:
        for path in write_contract(report["root"], report["contract"]):
            print(f"wrote {path}")
        return 0

    if args.update_baseline:
        path = args.baseline or engine.baseline_path(report["root"])
        before = len(engine.load_baseline(path))
        engine.save_baseline(path, report["findings"])
        after = len(report["findings"])
        print(f"baseline: {before} -> {after} entries ({path})")
        if after > before:
            print(
                "note: the baseline GREW — prefer fixing findings or "
                "pragma-ing intentional sites over baselining new debt."
            )
        return 0

    if args.format == "json":
        out = {
            "ok": report["ok"],
            "counts": {},
            "findings": [f.to_json() for f in report["findings"]],
            "new": [f.to_json() for f in report["new"]],
            "stale": report["stale"],
            "suppressed": report["suppressed"],
        }
        for f in report["findings"]:
            out["counts"][f.rule] = out["counts"].get(f.rule, 0) + 1
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        print(_render_friendly(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
