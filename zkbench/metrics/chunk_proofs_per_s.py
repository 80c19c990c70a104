"""Chunk proofs completed over all the window's time.  Host clock."""


def read(rec):
    if not rec.requests or rec.window_s <= 0:
        return None
    return sum(d.units for d in rec.requests if d.ok) / rec.window_s
