"""host_wait_ms.train: host milliseconds per step in `wait` spans, where the host
blocked on the device (a synchronise, `.item()`, a copy the device had to finish
first). From the program's own spans (benchmark/spans.py); absent without them, or
when the tracer counts another number of steps than the window ran."""
from benchmark import spans


def read(rec):
    if rec["kind"] != "train":
        return None
    split = spans.split_ms(rec)
    return None if split is None else split["wait"]
