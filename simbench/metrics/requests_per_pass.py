"""Valid requests generated a pass: the `valid` mask of every stream
`api.simulator.decoded_streams` returns, summed over the pass's groups
and averaged over the traced passes."""

LAYER = "streams"
UNIT = "requests"
MOVES = "designs_per_s"
READS = "a counter of the valid mask decoded_streams returns"
SPANS = {"streams": "repro_torch.api.simulator:decoded_streams"}


def _count(args, kwargs, out):
    (_, _, _, _, _, valid), _, _ = out
    return {"valid_requests": int(valid.sum())}


COUNTERS = [("streams", _count)]


def read(trace):
    ps = [p for p in trace["passes"] if "valid_requests" in p["counts"]]
    if not ps:
        return None
    return sum(p["counts"]["valid_requests"] for p in ps) / len(ps)
