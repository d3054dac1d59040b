"""Plaintext bytes of every decompress call of the window (1 MB = 10**6
B) over the sum of those calls' wall times."""


def read(run):
    done = [r for r in run.records if r.t_decompress is not None]
    t = sum(r.t_decompress for r in done)
    return sum(r.size for r in done) / t / 1e6 if t else None
