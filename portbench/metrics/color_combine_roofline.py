"""color_combine_roofline: the color-set combine's share of its roofline, in %.

The least time of every launch in the traced window (the frozen
``color_combine`` work at the launch's shapes through the frozen
``bound_s``), summed, over the device time of the ``color_combine_kernel``
launches the profiler saw.  Nothing where the kernel did not run, or ran
another number of times than the plan's combine nodes say."""

KERNEL = "color_combine_kernel"


def read(ctx):
    seconds = ctx["kernel_seconds"](KERNEL)
    expected = ctx["expected_launches"].get("color_combine", 0)
    if not seconds or not expected or ctx["kernel_launches"](KERNEL) != expected:
        return None
    return 100.0 * ctx["bound_s"]["color_combine"] / seconds
