"""mlp_host_ms.train: host milliseconds per step inside the MLP op's spans (`mlp.*`:
encodings, weight layout, argument checks and launches), less the `wait` spans
inside them. From the program's own spans (benchmark/spans.py); absent without them,
or when the tracer counts another number of steps than the window ran."""
from benchmark import spans


def read(rec):
    if rec["kind"] != "train":
        return None
    split = spans.split_ms(rec)
    return None if split is None else split["mlp"]
