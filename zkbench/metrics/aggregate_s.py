"""Seconds a request: the window's time over the requests completed in it.
Host clock, the window synchronised at both ends."""


def read(rec):
    if not rec.requests:
        return None
    return rec.window_s / len(rec.requests)
