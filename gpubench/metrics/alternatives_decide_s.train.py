"""The alternatives' keep rule (train/estep_device.py
prune_alternatives_device: the flags and the per-token lists of the flat
ids): the program's span `prune.alternatives.decide`, in s a stage
run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.alternatives.decide")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
