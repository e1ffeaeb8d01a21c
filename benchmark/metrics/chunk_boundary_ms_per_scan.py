"""Host ms a scan at run_chunked's window boundaries: the program's host
spans run_chunked.poses (the window's poses read back, where the host
waits for the device to finish the window it queued) and run_chunked.loop
(the loop detector's store and detect calls), summed over the run's
untraced calls, over the scans they stepped (the span step.outputs). None
where the program has no such spans, or no compiled step is cached."""

from benchmark.metrics.chunked_staging_ms_per_scan import ms_per_scan

BOUNDARY = ("run_chunked.poses", "run_chunked.loop")


def read(ctx, name):
    return ms_per_scan(ctx, BOUNDARY)
