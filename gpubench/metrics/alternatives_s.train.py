"""The alternatives (train/estep_device.py prune_alternatives_device),
around _alternatives: in s a stage run."""


def read(ctx):
    if not ctx.get("runs") or "gpubench.alternatives" not in ctx["spans"]:
        return None
    return ctx["spans"]["gpubench.alternatives"] / ctx["runs"]
