"""Mean device time of one PS step in the window, from the CUDA event pair
around each ``launch.train.ps_step`` call (first op to last, gaps
included)."""


def read(ctx):
    ms = ctx.get("spans", {}).get("ps_step")
    return sum(ms) / len(ms) if ms else None
