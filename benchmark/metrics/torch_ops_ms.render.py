"""torch_ops_ms.render: device milliseconds per frame of the operations launched outside
the MLP op's entry points: the renderer, sampling, losses and Adam in
PyTorch's own kernels. Absent when the op's entry points are gone."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "render" or tr is None or not tr["mlp_device_s"]:
        return None
    return 1000.0 * tr["other_device_s"] / tr["units"]
