"""Plaintext bytes of every compress call of the window (1 MB = 10**6 B)
over the sum of those calls' wall times."""


def read(run):
    t = sum(r.t_compress for r in run.records)
    return sum(r.size for r in run.records) / t / 1e6 if t else None
