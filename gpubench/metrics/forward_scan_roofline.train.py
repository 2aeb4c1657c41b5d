"""forward_scan (csrc/forward_chunk.cu, f32) in the E-steps: the least
time the E-steps' positions need (kernels_work.forward_scan) over the
kernel's device time in the traced window, in %."""

from gpubench.harness import kernel_seconds


def read(ctx):
    if not ctx.get("runs"):
        return None
    t = kernel_seconds(ctx["kernels"], "forward_scan_kernel")
    if t <= 0:
        return None
    return 100.0 * ctx["bound_s"]["forward_scan"] / t
