"""The trainer's host work (train/prune.py: the M-steps, the loss
ranking, the Model builds, the rebinds): a stage run's time less its
four spans, in s a stage run."""


def read(ctx):
    if not ctx.get("runs"):
        return None
    return (ctx["run_s"] - sum(ctx["spans"].values())) / ctx["runs"]
