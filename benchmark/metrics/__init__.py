"""Readers of the per-layer metrics, one module per family (the metric's
name before the first dot): read(ctx, name) returns the value, or None
where the run holds nothing to read. ctx: "run" (harness.Run), "stretch"
(trace.Stretch of the traced stretch, or None), "spans" (the harness's
spans over the window, the traced stretch left out; run.span_scans scans),
"counters" (the program's launch counters over the traced stretch, by
roofline kernel) and "rooflines" (the roofline modules)."""
