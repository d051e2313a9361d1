"""mlp_host_ms.render: host milliseconds per frame inside the MLP op's spans (`mlp.*`:
encodings, weight layout, argument checks and launches), less the `wait` spans
inside them. From the program's own spans (benchmark/spans.py); absent without them,
or when the tracer counts another number of frames than the window ran."""
from benchmark import spans


def read(rec):
    if rec["kind"] != "render":
        return None
    split = spans.split_ms(rec)
    return None if split is None else split["mlp"]
