"""mfu.train: the MLP operations the steps of the traced window need
(benchmark/counts.py) over the traced window's length, as a share (%) of
the card's peak for the compute dtype."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or tr is None:
        return None
    return 100.0 * rec["work_per_unit"]["flops"] * tr["units"] / tr["window_s"] / rec["peak_flops"]
