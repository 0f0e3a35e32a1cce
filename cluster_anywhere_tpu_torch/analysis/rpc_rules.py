"""Pass 1 checks: cross-check the extracted contract.

rpc-unknown-method   a call site names a method no peer handles — a typo'd
                     string would otherwise surface only as a runtime
                     reply_err (or, for a notify, as nothing at all).
rpc-dead-handler     a handler no call site ever reaches: dead code, or the
                     caller was refactored away and nobody noticed.
rpc-missing-field    a literal call site omits a field every handler for the
                     method reads via `msg["x"]` — a guaranteed KeyError (or
                     reply_err) when that site fires.
rpc-unread-field     a literal call site sends a field no handler for the
                     method ever reads (and every handler's read set is
                     closed): wire bytes for nothing, usually a renamed or
                     half-removed field.

Required fields are intersected across surfaces handling the same method (a
site targets one peer; we don't resolve which), read fields are unioned, and
any opaque handler disables unread-field checks for its method.
"""

from __future__ import annotations

from typing import Dict, List, Set

from .contract import RESERVED_FIELDS, Contract
from .engine import Finding

RULES = {
    "rpc-unknown-method": (
        "a call site names an RPC method no peer surface handles — a typo'd "
        "string surfaces only as a runtime reply_err, or as nothing at all"
    ),
    "rpc-dead-handler": (
        "a handler no call site anywhere reaches: dead code, or the caller "
        "was refactored away unnoticed"
    ),
    "rpc-missing-field": (
        "a literal call site omits a field every handler for the method "
        "reads unconditionally — a guaranteed KeyError when it fires"
    ),
    "rpc-unread-field": (
        "a literal call site sends a field no handler for the method reads "
        "— wire bytes for nothing, usually a renamed or half-removed field"
    ),
    "parse-error": (
        "a file under analysis does not parse, so no pass can see it"
    ),
}


def check(contract: Contract) -> List[Finding]:
    findings: List[Finding] = []
    handler_methods = contract.handler_methods()
    called_methods = contract.called_methods()

    by_method: Dict[str, list] = {}
    for h in contract.handlers:
        by_method.setdefault(h.method, []).append(h)

    seen: Set[str] = set()  # fingerprint dedup (same site shape repeated)

    def emit(f: Finding):
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            findings.append(f)

    for site in contract.call_sites:
        if site.method not in handler_methods:
            emit(Finding(
                rule="rpc-unknown-method", file=site.file, line=site.line,
                context=site.context,
                message=(
                    f"{site.kind} names RPC method {site.method!r} but no "
                    f"peer surface handles it"
                ),
                detail=site.method,
            ))
            continue
        handlers = by_method[site.method]
        if site.fields is None:
            continue  # dynamic field set: method check only
        required = None
        for h in handlers:
            required = h.required if required is None else (required & h.required)
        for field in sorted((required or set()) - site.fields - RESERVED_FIELDS):
            emit(Finding(
                rule="rpc-missing-field", file=site.file, line=site.line,
                context=site.context,
                message=(
                    f"{site.kind} of {site.method!r} never sends {field!r}, "
                    f"which every handler reads as msg[{field!r}]"
                ),
                detail=f"{site.method}.{field}",
            ))
        if any(h.opaque for h in handlers):
            continue
        read: Set[str] = set()
        for h in handlers:
            read |= h.required | h.optional
        for field in sorted(site.fields - read - RESERVED_FIELDS):
            emit(Finding(
                rule="rpc-unread-field", file=site.file, line=site.line,
                context=site.context,
                message=(
                    f"{site.kind} of {site.method!r} sends {field!r} but no "
                    f"handler for the method reads it"
                ),
                detail=f"{site.method}.{field}",
            ))

    for h in contract.handlers:
        if h.surface == "protocol":
            continue
        if h.method not in called_methods:
            emit(Finding(
                rule="rpc-dead-handler", file=h.file, line=h.line,
                context=h.context,
                message=(
                    f"{h.surface} handler for {h.method!r} has no call site "
                    f"anywhere in the repo (dead code?)"
                ),
                detail=f"{h.surface}:{h.method}",
            ))
    return findings
