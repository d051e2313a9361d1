"""torch_host_ms.render: host milliseconds per frame inside the `frame` span and
outside the `mlp.*` and `wait` spans: the renderer, sampling, losses and Adam,
Python and PyTorch's own ops. From the program's own spans (benchmark/spans.py);
absent without them, or when the tracer counts another number of frames than the
window ran."""
from benchmark import spans


def read(rec):
    if rec["kind"] != "render":
        return None
    split = spans.split_ms(rec)
    return None if split is None else split["torch"]
