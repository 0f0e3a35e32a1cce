"""Static analysis for the cluster: `ca lint`.

The wire protocol is schema-by-convention — handlers dispatch on a string
method name (`head._handle` does `getattr(self, "_h_" + m)`), call sites name
methods as string literals, and handlers read `msg["field"]` — so nothing in
the type system catches a typo'd method, a field nobody sends, or a handler no
caller reaches.  The reference gets all of that for free from protobuf
(`src/ray/protobuf/*.proto`); we get it from this package instead: a stdlib
`ast` analyzer with five passes.

Pass 1 (contract.py + rpc_rules.py) extracts every RPC handler table and every
call site into a machine-readable contract (docs/PROTOCOL_CONTRACT_TORCH.json,
`ca lint --contract`) and cross-checks them: unknown methods, dead handlers,
required-but-unsent fields, sent-but-unread fields.

Pass 2 (async_rules.py) audits the event-loop code: blocking calls inside
`async def`, fire-and-forget `create_task`/`ensure_future` whose failures
would vanish, and read-modify-write of shared state split across an `await`.

Passes 3-5 are *path* analyses over an intraprocedural CFG + worklist
dataflow framework (cfg.py, dataflow.py):

Pass 3 (resource_rules.py) tracks acquire/release disciplines (fds, files,
connections, locks, arena slices — declared in a one-line-per-pair REGISTRY)
and reports paths that leak on raise/return, loop-carried re-acquires, and
non-idempotent double releases.

Pass 4 (await_rules.py) flags network dials/reads/drains no timeout
dominates (async-unbounded-io) — the fix surface is util/aio.py's dial()/
read_frame()/drain() bounded helpers.

Pass 5 (cancel_rules.py) enforces cancellation hygiene: generic excepts that
swallow CancelledError around awaits, and awaits inside finally: blocks that
mask the in-flight exception (fix: util.aio.finally_await).

Findings flow through a checked-in baseline (analysis/baseline.json): accepted
pre-existing findings don't fail CI, new findings do, and baseline entries
whose code no longer exists fail too — the baseline only shrinks.  Intentional
dynamics are annotated in source with `# ca-lint: ignore[rule]` pragmas, which
beat baseline entries (visible at the site, not in a side file).

No dependencies beyond the standard library: the analyzer must run anywhere
the repo checks out, including CI images without the runtime deps.
"""

from .engine import Finding, run_lint  # noqa: F401
