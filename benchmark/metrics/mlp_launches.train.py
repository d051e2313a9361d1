"""mlp_launches.train: launches of K1, K2 and K3 per step in the compute
dtype, from the op's own counters (fused_mlp.launch_counts)."""


def read(rec):
    if rec["kind"] != "train" or rec.get("trace") is None:
        return None
    launches = rec["launches"]
    return sum(launches.get(k, 0) for k in ("K1", "K2", "K3")) / rec["units"]
