"""The pair insert (csrc/pair_count.cu `insert_ids_kernel`) in merge's
pair counts: the least time the passes' ids need
(pairs_work.pair_insert: ids and span offsets read, distinct rows
written, one hash a pair) over the kernel's device time in the traced
window, in %."""

from gpubench.harness import kernel_seconds


def read(ctx):
    if not ctx.get("runs"):
        return None
    t = kernel_seconds(ctx["kernels"], "insert_ids_kernel")
    if t <= 0:
        return None
    return 100.0 * ctx["bound_s"]["pair_insert"] / t
