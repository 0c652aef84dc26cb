"""Process start to the window's opening: imports, kernel libraries,
weights drawn from the seed, the input pool, the warm-up jobs."""


def read(rec, ctx):
    return rec.setup_s
