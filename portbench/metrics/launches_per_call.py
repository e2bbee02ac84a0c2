"""launches_per_call: the port's own kernel launch counters
(``kernels/_build.count_launch``, every wrapper ``kernels/ops`` exports),
summed over the traced window and divided by its calls."""


def read(ctx):
    total = sum(ctx["launches"].values())
    return total / ctx["calls"] if total and ctx["calls"] else None
