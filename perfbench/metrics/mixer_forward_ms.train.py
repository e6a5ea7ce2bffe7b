"""Device time of the sequence mixers in one worker gradient's forward:
the port's ``model.attention`` (``transformer._attn_block``) and
``model.ssd`` (``ssm._ssd``) spans under ``worker.forward``, summed, per
``worker.grad`` span, in the stretch with the port's spans on. The
recompute under remat (the same spans under ``worker.backward``) is left
out."""
from perfbench.lib import program


def read(ctx):
    return program.span_ms(ctx, "model.attention", "model.ssd",
                           under="worker.forward", per="worker.grad")
