"""The batching service's coalescing in the measured window: the queries it
answered over the device dispatches it made (`metrics()` counters of
`BatchingRetrievalService`)."""


def read(r):
    svc = getattr(r, "service", None)
    if not svc or not svc.get("dispatches"):
        return None
    return svc["queries"] / svc["dispatches"]
