"""Share (%) of the traced window in which no operation ran on the device,
in a cell whose calls each build a model."""

from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx, ctx.models)
