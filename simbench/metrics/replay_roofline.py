"""The replay's share of its roofline: the least time of the work the
replay calls received (`simbench/rooflines/replay.py`, from their shapes
and valid requests) over the time their spans took, in percent."""

import math

LAYER = "replay"
UNIT = "%"
MOVES = "designs_per_s"
READS = "the replay span and a counter of the shapes replay_requests gets"
SPANS = {"replay": "repro_torch.core.dram:replay_requests"}


def _count(args, kwargs, out):
    from simbench.rooflines.replay import replay_least_s
    t_issue, valid = args[0], args[5]
    S = math.prod(t_issue.shape[:-1])
    return {"replay_least_s": replay_least_s(S, t_issue.shape[-1],
                                             int(valid.sum()))}


COUNTERS = [("replay", _count)]


def read(trace):
    ps = [p for p in trace["passes"]
          if "replay" in p["spans"] and "replay_least_s" in p["counts"]]
    spent = sum(p["spans"]["replay"] for p in ps) / 1e3
    if not ps or spent <= 0:
        return None
    return 100.0 * sum(p["counts"]["replay_least_s"] for p in ps) / spent
