"""The 95th percentile of every request's latency in the window, from the
raw samples: issue to the row on the host (host clock)."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies_ms, 95)) if ctx.latencies_ms else None
