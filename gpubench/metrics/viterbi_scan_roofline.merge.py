"""viterbi_scan (csrc/viterbi_chunk.cu, f32, the LMAX 32 instantiation at
merge's 20 lengths) in merge's pair counts: the least time the passes'
positions need (kernels_work.viterbi_scan at L = 20, every corpus byte a
pass) over the kernel's device time in the traced window, in %."""

from gpubench.harness import kernel_seconds


def read(ctx):
    if not ctx.get("runs"):
        return None
    t = kernel_seconds(ctx["kernels"], "viterbi_scan_kernel")
    if t <= 0:
        return None
    return 100.0 * ctx["bound_s"]["viterbi_scan"] / t
