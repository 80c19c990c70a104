"""Set-up: process start to the window's first request (imports, the card,
the kernels' build on a checkout's first run, the warm-up requests and
the pool of inputs).  Host clock."""


def read(rec):
    return rec.setup_s
