"""p95_batch_ms: the 95th percentile (linear) of every window batch's
latency, CUDA events around the call on the device's clock."""

import numpy as np


def read(rec):
    lat = rec["window"]["batch_ms"]
    return float(np.percentile(np.asarray(lat, dtype=np.float64), 95)) if lat else None
