"""torch_host_ms.train: host milliseconds per step inside the `step` span and outside
the `mlp.*` and `wait` spans: the renderer, sampling, losses and Adam, Python and
PyTorch's own ops. From the program's own spans (benchmark/spans.py); absent without
them, or when the tracer counts another number of steps than the window ran."""
from benchmark import spans


def read(rec):
    if rec["kind"] != "train":
        return None
    split = spans.split_ms(rec)
    return None if split is None else split["torch"]
