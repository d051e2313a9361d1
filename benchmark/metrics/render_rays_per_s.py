"""render_rays_per_s: rays of the full frames completed in the window
(frames x H x W) over the window's length."""


def read(rec):
    if rec["kind"] != "render":
        return None
    return rec["units"] * rec["rays_per_unit"] / rec["window_s"]
