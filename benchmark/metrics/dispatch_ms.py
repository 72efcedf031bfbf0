"""dispatch_ms: the benchmark's own span, the host time from the call of
the program's entry point to its return (before the benchmark's device
synchronize), as a mean over the traced batches, in milliseconds. Where
the host waits on a full launch queue inside the call, that wait is in."""


def read(tr):
    if not tr.dispatch_s:
        return None
    return 1000.0 * sum(tr.dispatch_s) / len(tr.dispatch_s)
