"""batch_occupancy.stream: requests a device call of the port's MicroBatcher
(its `requests` and `calls` counters) over the window."""

UNIT, BETTER, MOVES = "requests/call", "higher", "request_p95_ms"


def read(run):
    calls = run.counters.get("calls", 0)
    return run.counters["requests"] / calls if calls else None
