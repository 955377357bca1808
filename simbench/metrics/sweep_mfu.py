"""The whole pass's share of the chip's float32 peak: the least time of
the work the pass's frame needs (`simbench/rooflines/sweep.py`, counted
from its designs and ops) over the pass's wall, summed over the traced
passes, in percent."""

LAYER = "device"
UNIT = "%"
MOVES = "designs_per_s"
READS = "the pass span and the pass's designs and ops"


def read(trace):
    from simbench.rooflines.sweep import pass_least_s
    ps = trace["passes"]
    wall = sum(p["wall_ms"] for p in ps) / 1e3
    if not ps or wall <= 0:
        return None
    spec = trace["mix"]["trace_spec"]
    least = {}
    for p in ps:
        if p["sample"] not in least:
            least[p["sample"]] = pass_least_s(p["designs"], trace["ops"],
                                              spec)
    return 100.0 * sum(least[p["sample"]] for p in ps) / wall
