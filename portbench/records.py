"""The program's proof records (halo2tpu_torch/utils/trace.py), as the
readers of its spans and counters see them: a window total over the
window's completed proofs.  Each gives None unless the program kept one
record for each traced proof of the window (the warm-up passes no
tracer), so a program that keeps no records, or other records, reads
nothing."""
from __future__ import annotations


def _records(ctx):
    try:
        from halo2tpu_torch.utils.trace import recent
    except ImportError:         # a program that keeps no records
        return None
    records = recent()
    if not ctx.phases or not ctx.proofs or len(records) != len(ctx.phases):
        return None
    return records


def span_seconds(ctx, names):
    """Seconds in the spans named in names, start to end, a proof."""
    records = _records(ctx)
    if records is None:
        return None
    spans = [s for r in records for s in r.spans if s.name in names]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / ctx.proofs


def counter_total(ctx, name, scale=1):
    """The counter name's count, times scale, a proof."""
    records = _records(ctx)
    if records is None or not any(name in r.counters for r in records):
        return None
    return sum(r.counters.get(name, 0) for r in records) * scale / ctx.proofs
