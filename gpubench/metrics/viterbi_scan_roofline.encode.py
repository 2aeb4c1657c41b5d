"""viterbi_scan (csrc/viterbi_chunk.cu, f32) in encode: the least time
the requests' positions need (kernels_work.viterbi_scan) over the
kernel's device time in the traced window, in %."""

from gpubench.harness import kernel_seconds


def read(ctx):
    if not ctx.get("requests"):
        return None
    t = kernel_seconds(ctx["kernels"], "viterbi_scan_kernel")
    if t <= 0:
        return None
    return 100.0 * ctx["bound_s"]["viterbi_scan"] / t
