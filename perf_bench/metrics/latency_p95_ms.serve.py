"""``latency_p95_ms.serve``: the 95th percentile, over every frame returned
in the window, of the time from the frame's submit to its skeletons. In a
closed loop it follows the rate (cameras over frames a second) plus where a
frame falls against the batches, so it is read here, not bounded."""

import numpy as np


def read(job, outcome):
    lat = outcome.layer["latency_ms"]
    return float(np.percentile(lat, 95)) if lat else None
