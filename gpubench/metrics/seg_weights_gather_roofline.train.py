"""seg_weights_gather (csrc/seg_weights.cu seg_gather_kernel) in the
E-steps: the least time the E-steps' positions and lattice entries need
(kernels_work.seg_weights_gather) over the kernel's device time in the
traced window, in %."""

from gpubench.harness import kernel_seconds


def read(ctx):
    if not ctx.get("runs"):
        return None
    t = kernel_seconds(ctx["kernels"], "seg_gather_kernel")
    if t <= 0:
        return None
    return 100.0 * ctx["bound_s"]["seg_weights_gather"] / t
