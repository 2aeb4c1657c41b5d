"""Packing and batch preparation (utils/packing.py, DeviceCorpus,
prepare_batch*): phases `pack` and `prep`, in ms a request."""


def read(ctx):
    ph = ctx.get("phases") or {}
    if not ctx.get("requests") or not ({"pack", "prep"} & set(ph)):
        return None
    return (ph.get("pack", 0.0) + ph.get("prep", 0.0)) / ctx["requests"] * 1e3
