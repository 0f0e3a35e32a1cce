"""One driver per traffic kind: `cells/<kind>.py` exposes
`run(cell, seed, seconds, trace, device)` and returns the run's result."""
