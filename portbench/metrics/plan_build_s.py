"""plan_build_s: seconds of the host clock around the first access of the
program's sampler (``Counter.sample_fn``, or the family plan and sampler),
which builds the plan before any call: CSR to the card, the SpMM plan's
patch-density scan, the split tables."""


def read(ctx):
    return ctx["plan_build_s"]
