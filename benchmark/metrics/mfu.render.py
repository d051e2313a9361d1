"""mfu.render: the MLP operations the frames of the traced window need
(benchmark/counts.py) over the traced window's length, as a share (%) of
the card's peak for the compute dtype."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "render" or tr is None:
        return None
    return 100.0 * rec["work_per_unit"]["flops"] * tr["units"] / tr["window_s"] / rec["peak_flops"]
