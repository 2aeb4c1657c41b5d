"""The alternatives' packing (train/estep_device.py _pack_tokens: every
token of the vocabulary as a sample): the program's span
`prune.alternatives.pack`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.alternatives.pack")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
