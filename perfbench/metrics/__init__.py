"""One reader per per-layer metric: `metrics/<name>.py` exposes
`read(ctx) -> float | None`; None leaves the metric out of the line."""
