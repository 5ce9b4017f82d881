"""client_p95_ms.explore: the 95th percentile of every answered query's
time from send to answer, on the client, in ms (numpy's linear
percentile).  The loop is closed, so it is the analyst's wait."""
import numpy as np


def read(t):
    if t is None or not t.latencies:
        return None
    return float(np.percentile(np.asarray(t.latencies), 95.0)) * 1e3
