"""mlp_roofline.render: the least time the card could take for the MLP op's
counted work in the traced window (benchmark/counts.py: operations at the
dtype's peak, or bytes at HBM bandwidth, whichever is longer) over the device
time of every operation launched inside the op's entry points, as %.
Absent when an entry point the harness wraps is gone."""
from benchmark import counts


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "render" or tr is None or not tr["mlp_device_s"]:
        return None
    least, _ = counts.bound_seconds(rec["work_per_unit"], rec["dtype"])
    return 100.0 * least * tr["units"] / tr["mlp_device_s"]
