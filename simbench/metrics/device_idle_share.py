"""The share of the profiled passes' wall in which no operation ran on
the device: 1 - busy / wall, in percent, from torch.profiler over one
cycle of the run's samples after the traced window."""

LAYER = "device"
UNIT = "%"
MOVES = "designs_per_s"
READS = "torch.profiler's device trace of one cycle of passes"


def read(trace):
    prof = trace.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
