"""The whole PS step's share of the card's peak, which bytes bound: the
least bytes of every cycle of the window (``reference/cost.py``: the
``olaf_step`` cycle's, AdamW's, the screen's and the weighted mean's, from
each cycle's own metadata) over the card's HBM rate, divided by the
window's length."""


def read(ctx):
    peaks, nbytes = ctx.get("peaks"), ctx.get("ps_step_least_bytes")
    if not peaks or not nbytes or not ctx.get("window_s"):
        return None
    return 100.0 * nbytes / peaks["hbm_bytes"] / ctx["window_s"]
