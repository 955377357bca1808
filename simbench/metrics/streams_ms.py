"""Milliseconds a pass spends generating and decoding the demand streams
(`api.simulator.decoded_streams`: the stream designs' columns and
traffic, `trace.generator.gemm_request_stream`, `core.dram.
decode_requests`), summed over groups, averaged over the traced passes."""

LAYER = "streams"
UNIT = "ms"
MOVES = "designs_per_s"
READS = "the span around api.simulator.decoded_streams"
SPANS = {"streams": "repro_torch.api.simulator:decoded_streams"}


def read(trace):
    ps = [p for p in trace["passes"] if "streams" in p["spans"]]
    if not ps:
        return None
    return sum(p["spans"]["streams"] for p in ps) / len(ps)
