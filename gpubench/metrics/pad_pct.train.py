"""Padding of the packed rows (utils/packing.py pack_samples,
train/estep_device.py _pack_tokens): the share of packed positions that
hold no byte, 100 (pack.positions - pack.bytes) / pack.positions, in %."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    rec = trace.record()
    positions = rec.counter("pack.positions", "prune")
    if not ctx.get("runs") or not positions:
        return None
    return 100.0 * (positions - (rec.counter("pack.bytes", "prune") or 0)) \
        / positions
