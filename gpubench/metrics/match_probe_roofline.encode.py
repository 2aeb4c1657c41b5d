"""match_probe (csrc/match_probe.cu) in encode: the least time the
requests' positions need (kernels_work.match_probe) over the kernel's
device time in the traced window, in %."""

from gpubench.harness import kernel_seconds


def read(ctx):
    if not ctx.get("requests"):
        return None
    t = kernel_seconds(ctx["kernels"], "match_probe_kernel")
    if t <= 0:
        return None
    return 100.0 * ctx["bound_s"]["match_probe"] / t
