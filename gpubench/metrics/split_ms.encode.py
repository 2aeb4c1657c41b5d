"""Readback, the id split and the chained samples' host walk
(train/estep_device.py): phases `readback`, `split` and `backtrack`, in
ms a request."""


def read(ctx):
    ph = ctx.get("phases") or {}
    names = ("readback", "split", "backtrack")
    if not ctx.get("requests") or not any(n in ph for n in names):
        return None
    return sum(ph.get(n, 0.0) for n in names) / ctx["requests"] * 1e3
