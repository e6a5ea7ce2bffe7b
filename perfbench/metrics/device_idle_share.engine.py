"""Share of the profiled stretch in which no operation ran on the device:
100 x (1 - busy / window), busy the union of the device operations'
intervals."""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
