"""Times an iteration of the traced cycle that the program's step path
blocked the host on the device: the program's ``sync`` counter
(``repro_torch.tracing``: one per blocking host-to-device copy, per loss
read, per gradient-norm read, per RoPE theta copied in), summed over the
cycle and divided by its iterations. On a card an iteration's count equals
the blocking calls ``torch.cuda.set_sync_debug_mode`` reports over it
(``tests/test_torch_tracing.py``, marked ``cuda``), so a count cannot go
without its sync, nor a sync come without its count. Nothing where the
program has no such counter."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    n = sum(t.counters.get("sync", 0) for t in tracing.totals().values())
    if n <= 0 or not run.cycle:
        return None
    return n / run.cycle
