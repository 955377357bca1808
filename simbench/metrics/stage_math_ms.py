"""Milliseconds a pass spends in the sweep's per-design stage math
(`api.simulator._design_metrics`: mapping, SRAM and DRAM traffic,
energy, the sums over ops), summed over the pass's groups and averaged
over the traced passes."""

LAYER = "sweep columns + stage math"
UNIT = "ms"
MOVES = "designs_per_s"
READS = "the span around api.simulator._design_metrics"
SPANS = {"stage_math": "repro_torch.api.simulator:_design_metrics"}


def read(trace):
    ps = [p for p in trace["passes"] if "stage_math" in p["spans"]]
    if not ps:
        return None
    return sum(p["spans"]["stage_math"] for p in ps) / len(ps)
