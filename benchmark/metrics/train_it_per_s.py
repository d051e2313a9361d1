"""train_it_per_s: training iterations completed in the window over the
window's length; the window ends with a synchronise."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["units"] / rec["window_s"]
