"""The device's idle share over the traced window of stage runs, in %:
100 (1 - busy / window), busy the union of the device's kernels and
copies."""


def read(ctx):
    if not ctx.get("runs"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
