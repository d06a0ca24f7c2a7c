"""The mean wait of a call between its arrival and its start, over the
window's calls (host clock): the open loop's queue in front of the
estimator, which serves one call at a time."""


def read(trace):
    waits = trace["window"].get("queue_wait_ms")
    return sum(waits) / len(waits) if waits else None
