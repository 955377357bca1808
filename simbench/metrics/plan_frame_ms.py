"""Host milliseconds a pass spends in `Study.run` outside its groups'
sweep calls: building the study, planning the cells and groups, and the
frame. The pass's wall less its `_sweep_batched` spans, averaged over
the traced passes."""

LAYER = "study plan + frame"
UNIT = "ms"
MOVES = "designs_per_s"
READS = "the pass span less the span around api.study._sweep_batched"
SPANS = {"sweep": "repro_torch.api.study:_sweep_batched"}


def read(trace):
    ps = [p for p in trace["passes"] if "sweep" in p["spans"]]
    if not ps:
        return None
    return sum(p["wall_ms"] - p["spans"]["sweep"] for p in ps) / len(ps)
