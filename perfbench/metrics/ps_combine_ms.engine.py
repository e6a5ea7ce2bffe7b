"""Device time of the PS step's combine (the port's ``ps.combine`` span:
the weighted mean, or under the screen one ``olaf_robust_combine``
launch) per cycle, in the stretch with the port's spans on."""
from perfbench.lib import program


def read(ctx):
    return program.span_ms(ctx, "ps.combine")
