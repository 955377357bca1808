"""Milliseconds a pass spends in the DRAM replay (`core.dram.
replay_requests`: input preparation, the replay kernel
`csrc/replay_megakernel.cu`, the stall), summed over groups, averaged
over the traced passes."""

LAYER = "replay"
UNIT = "ms"
MOVES = "designs_per_s"
READS = "the span around core.dram.replay_requests"
SPANS = {"replay": "repro_torch.core.dram:replay_requests"}


def read(trace):
    ps = [p for p in trace["passes"] if "replay" in p["spans"]]
    if not ps:
        return None
    return sum(p["spans"]["replay"] for p in ps) / len(ps)
