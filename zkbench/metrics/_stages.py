"""The mean seconds of one attestation stage, from the spans that the
program's stage hook (`air.STAGE_HOOK`) ends, synchronised, in a traced run."""


def mean(rec, stage: str):
    durs = [(s.end_ns - s.start_ns) / 1e9 for s in rec.spans if s.name == "attest." + stage]
    return sum(durs) / len(durs) if durs else None
