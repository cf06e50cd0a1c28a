"""
Device time of a call on the card, with L2 warm or cold.

``time_ms`` times repeated calls on the same tensors (L2 warm);
``time_cold_ms`` writes and reads more than the H100's L2 before each
call (L2 cold). Both queue the calls behind a spinning kernel, so the
events time the card's work and not the host's dispatch.
``chip_smoke.py`` and the tools time with them.
"""

import statistics


def time_ms(fn, reps=5):
    """Device ms of one call of ``fn``: the calls are queued behind a
    spinning kernel, so the events time the card's work and not the host's
    dispatch. The spin grows until the host has queued every call before
    the card reaches the first event; where ``reps`` calls fill the launch
    queue, one call is timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 30:
            if reps > 1:
                # the calls' launches fill the launch queue (about 1024
                # entries: a chunked patch product launches hundreds), so
                # the host waits on the sleeping card: time one call
                return time_ms(fn, reps=1)
            raise RuntimeError("time_ms: the host did not get ahead of the "
                               "card; fn waits on the card")
        cycles <<= 2


#: bytes written (and read) between two cold calls: more than the H100's
#: 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def time_cold_ms(fn, reps=20, dirty=False):
    """Device ms of one call of ``fn`` with the L2 cache cold: a buffer of
    ``L2_FLUSH_BYTES`` is written before each call and, unless ``dirty``,
    a second one read after it, so that the call finds neither its
    tensors nor a dirty line in L2 (with ``dirty`` the call also writes
    back the lines it evicts). Each call is timed by its own pair of
    events; the median of ``reps``. The flushes and calls are queued
    behind a spinning kernel, as in ``time_ms``, so host dispatch is not
    in them."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    clean = None if dirty else torch.zeros(L2_FLUSH_BYTES // 4,
                                           device="cuda")
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    while True:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(cycles)
        for i, (start, end) in enumerate(events):
            flush.fill_(float(i))
            if clean is not None:
                clean.sum()
            start.record()
            fn()
            end.record()
        queued = not events[0][0].query()
        torch.cuda.synchronize()
        if queued:
            return statistics.median(s.elapsed_time(e) for s, e in events)
        if cycles >= 1 << 30:
            raise RuntimeError("time_cold_ms: the host did not get ahead of "
                               "the card; fn waits on the card")
        cycles <<= 2
