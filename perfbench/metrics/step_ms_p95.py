"""The 95th percentile of the milliseconds between successive loss reads
of the window, over all its steps (host clock): a read returns when the
host learns that a step finished."""

import statistics


def read(ctx):
    r = ctx.window["reads"]
    gaps = [(b - a) * 1e3 for a, b in zip(r, r[1:])]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=100, method="inclusive")[94]
