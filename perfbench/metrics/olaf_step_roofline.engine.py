"""The ``olaf_step`` kernel's share of its roofline in the profiled
stretch: the least bytes of its cycles (``reference/cost.py``, from each
call's own queue metadata and burst) over the card's HBM rate, divided by
the kernel's device time there. Bytes bound it (its operations are one
add, multiply or divide per element moved)."""


def read(ctx):
    prof, peaks = ctx.get("profile"), ctx.get("peaks")
    nbytes = ctx.get("olaf_step_least_bytes")
    if prof is None or not peaks or not nbytes:
        return None
    secs = sum(s for name, (_, s) in prof.ops.items()
               if "olaf_step_kernel" in name)
    if secs <= 0:
        return None
    return 100.0 * nbytes / peaks["hbm_bytes"] / secs
