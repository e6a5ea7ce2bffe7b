"""Mean device time of one worker gradient in the window, from the CUDA
event pair around each ``launch.train.worker_grad`` call (first op to
last, gaps included)."""


def read(ctx):
    ms = ctx.get("spans", {}).get("worker_grad")
    return sum(ms) / len(ms) if ms else None
