"""Host ms a step inside the expert layers' spans ``moe.route`` (scores,
top-k, sort, offsets) and ``moe.experts`` (gather, grouped products,
combine) of the traced training epoch."""
from benchmark import spans


def read(run):
    s = spans.session(run, "train")
    if s is None or "moe.route" not in s["total_ms"]:
        return None
    ms = s["total_ms"]["moe.route"] + s["total_ms"].get("moe.experts", 0.0)
    return ms / s["count"]["train.step"]
