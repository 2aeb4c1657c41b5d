"""The share of merge's encoded bytes redone with the exact probe (the
samples whose paths took a span that is no token: the bucket probe's
false matches, train/estep_device.py `_redo_exact`): 100
probe.redone_bytes / (corpus bytes x pair counts), in %; 0 where the
pair counts ran and redid nothing."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    rec = trace.record()
    passes = rec.calls("merge.count")
    if not ctx.get("runs") or not passes:
        return None
    redone = rec.counter("probe.redone_bytes", "merge") or 0
    return 100.0 * redone / (ctx["corpus_bytes"] * passes)
