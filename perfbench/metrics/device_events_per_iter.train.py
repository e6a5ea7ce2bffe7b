"""Device operations (kernels, copies, fills) per trainer iteration, in
the profiled stretch after the window."""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or not prof.iters or not prof.device_events:
        return None
    return prof.device_events / prof.iters
