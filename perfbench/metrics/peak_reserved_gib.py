"""torch.cuda.max_memory_reserved() over the whole run, set-up included
(it counts the graph pools that allocated memory misses)."""


def read(rec, ctx):
    return rec.peak_reserved / 2 ** 30 if rec.peak_reserved else None
