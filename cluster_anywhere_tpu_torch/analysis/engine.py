"""Lint engine: file collection, findings, pragma suppression, baselines.

The engine is rule-agnostic: rules (rpc_rules, async_rules) return Finding
lists; the engine suppresses pragma'd ones, diffs the rest against the
checked-in baseline, and renders reports.  Fingerprints deliberately exclude
line numbers so unrelated edits above a finding don't churn the baseline —
a finding is identified by (rule, file, context, detail).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

# directories never scanned (relative path components)
_SKIP_DIRS = {"__pycache__", ".git", "tests", "build", "dist"}


def dotted_name(node) -> Optional[str]:
    """Flatten `a.b.c` Attribute chains to "a.b.c"; None for anything whose
    base isn't a plain Name.  Shared by every rule module."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None

# the marker may share a comment with prose ("# operator probe: ca-lint: …")
PRAGMA_RE = re.compile(r"#.*?ca-lint:\s*ignore(?:\[([a-z0-9_,\- ]+)\])?")


@dataclasses.dataclass
class Finding:
    rule: str      # e.g. "rpc-unknown-method"
    file: str      # repo-relative posix path
    line: int      # 1-based; display only, not part of the fingerprint
    context: str   # dotted qualname ("Head._h_register") or "surface:method"
    message: str   # human sentence
    detail: str = ""  # stable key material; defaults to message

    @property
    def fingerprint(self) -> str:
        key = "|".join((self.rule, self.file, self.context, self.detail or self.message))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "context": self.context,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed module: path, source lines, AST, and pragma map."""

    def __init__(self, root: str, relpath: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.abspath = os.path.join(root, relpath)
        with open(self.abspath, "r", encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.relpath)
        # line -> set of ignored rules (empty set = ignore every rule)
        self.pragmas: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(text)
            if m:
                rules = m.group(1)
                self.pragmas[i] = (
                    {r.strip() for r in rules.split(",") if r.strip()}
                    if rules else set()
                )

    def suppressed(self, finding: Finding) -> bool:
        """A pragma on the finding's line (or the line above it, for sites
        too long to carry a trailing comment) suppresses matching rules.
        Findings anchored at a decorated `def` climb the decorator stack so
        a pragma above `@decorator` lines still scopes to the def."""
        def hit(ln: int) -> bool:
            rules = self.pragmas.get(ln)
            return rules is not None and (not rules or finding.rule in rules)

        if hit(finding.line) or hit(finding.line - 1):
            return True
        ln = finding.line - 1
        while ln >= 1 and self.lines[ln - 1].lstrip().startswith("@"):
            ln -= 1
            if hit(ln):
                return True
        return False


PACKAGE = "cluster_anywhere_tpu_torch"


def default_subpaths(root: str) -> Tuple[str, ...]:
    """The package plus its scripts (scripts/torch_*.py); the JAX package,
    its scripts, chip_smoke.py and tests/ are not the port's code."""
    scripts = os.path.join(root, "scripts")
    names = sorted(os.listdir(scripts)) if os.path.isdir(scripts) else []
    return (PACKAGE,) + tuple(
        f"scripts/{n}" for n in names if n.startswith("torch_") and n.endswith(".py")
    )


def collect_files(root: str, subpaths: Optional[Iterable[str]] = None) -> List[SourceFile]:
    """Parse every .py under `subpaths` (default: default_subpaths).  Tests
    are excluded: they exercise fake methods and sockets on purpose, and a
    handler only a test reaches is still dead code."""
    if subpaths is None:
        subpaths = default_subpaths(root)
    def load(rel: str) -> SourceFile:
        try:
            return SourceFile(root, rel)
        except (SyntaxError, UnicodeDecodeError):
            # a file the analyzer can't parse is a finding, not a crash
            sf = object.__new__(SourceFile)
            sf.relpath = rel.replace(os.sep, "/")
            sf.abspath = os.path.join(root, rel)
            sf.source, sf.lines, sf.tree, sf.pragmas = "", [], None, {}
            return sf

    out: List[SourceFile] = []
    for sub in subpaths:
        top = os.path.join(root, sub)
        if os.path.isfile(top):
            out.append(load(sub))
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in sorted(dirnames) if d not in _SKIP_DIRS]
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                out.append(load(os.path.relpath(os.path.join(dirpath, name), root)))
    return out


# --------------------------------------------------------------- baselines

def load_baseline(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("findings", []))


def save_baseline(path: str, findings: List[Finding]) -> None:
    entries = sorted(
        (f.to_json() for f in findings),
        key=lambda e: (e["rule"], e["file"], e["context"], e["fingerprint"]),
    )
    for e in entries:
        e.pop("line", None)  # line drift must not churn the baseline
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=1, sort_keys=True)
        f.write("\n")


def diff_baseline(
    findings: List[Finding], baseline: List[dict]
) -> Tuple[List[Finding], List[dict]]:
    """Returns (new_findings, stale_entries).  Stale = baseline entries whose
    finding no longer exists: the code was fixed or removed, so the entry must
    be dropped (`ca lint --update-baseline`) — the baseline only shrinks."""
    current = {f.fingerprint for f in findings}
    known = {e["fingerprint"] for e in baseline}
    new = [f for f in findings if f.fingerprint not in known]
    stale = [e for e in baseline if e["fingerprint"] not in current]
    return new, stale


# ------------------------------------------------------------------ driver

def default_root() -> str:
    """The repo root: the directory holding the cluster_anywhere_tpu_torch
    package this module was imported from (works from any cwd), else cwd."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if os.path.isdir(os.path.join(here, PACKAGE)):
        return here
    return os.getcwd()


def baseline_path(root: str) -> str:
    return os.path.join(root, PACKAGE, "analysis", "baseline.json")


# the single pass registry: name -> rule module (each exports check() over
# the file list — "rpc" over the extracted contract — plus a RULES dict).
# ALL_PASSES, all_rules(), and run_lint() all derive from this one table.
_PASS_MODULES = {
    "rpc": "rpc_rules",
    "async": "async_rules",
    "res": "resource_rules",
    "await": "await_rules",
    "cancel": "cancel_rules",
}
ALL_PASSES = tuple(_PASS_MODULES)


def _pass_module(name: str):
    import importlib

    return importlib.import_module(f".{_PASS_MODULES[name]}", __package__)


def all_rules() -> Dict[str, Dict[str, str]]:
    """pass name -> {rule name -> one-line description}, for `ca lint
    --rules` and the generated docs/PROTOCOL_CONTRACT_TORCH.md."""
    return {name: dict(_pass_module(name).RULES) for name in ALL_PASSES}


def run_lint(
    root: Optional[str] = None,
    passes: Iterable[str] = ALL_PASSES,
    baseline_file: Optional[str] = None,
) -> dict:
    """Run the analyzer over the repo.  Returns a report dict:

    {"findings": [Finding...]   (unsuppressed, both baselined and new),
     "new": [Finding...], "stale": [baseline entries...],
     "suppressed": int, "contract": Contract, "ok": bool}
    """
    from . import contract

    passes = tuple(passes)
    unknown = sorted(set(passes) - set(_PASS_MODULES))
    if unknown:
        # a typo'd pass name must not silently run zero checks and pass CI
        raise ValueError(f"unknown lint pass(es) {unknown}; valid: {ALL_PASSES}")

    root = root or default_root()
    files = collect_files(root)
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            findings.append(Finding(
                rule="parse-error", file=sf.relpath, line=1, context=sf.relpath,
                message=f"{sf.relpath} does not parse; the analyzer cannot see it",
            ))

    extracted = contract.extract_contract(files)
    for name in ALL_PASSES:
        if name in passes:
            mod = _pass_module(name)
            findings.extend(mod.check(extracted if name == "rpc" else files))

    by_file = {sf.relpath: sf for sf in files}
    kept: List[Finding] = []
    suppressed = 0
    for f in findings:
        sf = by_file.get(f.file)
        if sf is not None and sf.suppressed(f):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.rule))

    baseline = load_baseline(baseline_file or baseline_path(root))
    new, stale = diff_baseline(kept, baseline)
    return {
        "root": root,
        "findings": kept,
        "new": new,
        "stale": stale,
        "suppressed": suppressed,
        "contract": extracted,
        "ok": not new and not stale,
    }
