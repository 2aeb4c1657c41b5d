"""The M-steps (train/prune.py run_m_step: the digamma rescoring and a
clone_with_score per token): the program's span `prune.m_step`, in s a
stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.m_step")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
