"""The loss ranking (train/prune.py _remove_by_loss: each token's loss
from its frequency and alternatives, the sorts): the program's span
`prune.loss`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.loss")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
