"""Seconds a request spends on the gRPC hop: the client's "grpc.call" span
(the request built, serialised, sent over the loopback channel, and the
response received and parsed) less the server's "grpc.handle" span of the
same request (the prover's work on the handler thread), mean over the
requests of the traced window.  A call and a handle are paired by their
request id and kind; a call without its handle is left out.  A program
without these spans gives none, and the reader nothing."""

from ._program import spans


def read(rec):
    got = spans(rec)
    handles = {}
    for s in got:
        if s.name == "grpc.handle":
            handles[(s.request, s.attrs.get("kind"))] = s
    hops = []
    for s in got:
        h = handles.get((s.request, s.attrs.get("kind"))) if s.name == "grpc.call" else None
        if h is not None:
            hops.append((s.end_ns - s.start_ns - (h.end_ns - h.start_ns)) / 1e9)
    return sum(hops) / len(hops) if hops else None
