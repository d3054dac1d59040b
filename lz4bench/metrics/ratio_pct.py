"""Compressed bytes over plaintext bytes, times 100, over every frame the
window wrote."""


def read(run):
    done = [r for r in run.records if r.frame is not None]
    n = sum(r.size for r in done)
    return 100.0 * sum(len(r.frame) for r in done) / n if n else None
