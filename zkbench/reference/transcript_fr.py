"""The wrap profile's Fiat-Shamir transcript: a Poseidon2-Fr duplex sponge
on host python ints, every absorbed value and every squeezed challenge one
Fr element.  A Goldilocks challenge is the low 63 bits of a squeeze, a query
index its low log2(n) bits; the grinding nonce is checked, not searched."""

from __future__ import annotations

from . import poseidon_fr as pfr
from .poseidon_fr import R, RATE, WIDTH, sha_to_fr

GL_CHALLENGE_BITS = 63


class TranscriptFr:
    def __init__(self, domain: str):
        self._state = [0] * WIDTH
        self._pos = 0
        self._absorb_one(sha_to_fr("ezt-transcript-fr/" + domain))

    def _permute(self):
        self._state = pfr.perm_host(self._state)
        self._pos = 0

    def _absorb_one(self, v: int):
        if self._pos == RATE:
            self._permute()
        self._state[self._pos] = (self._state[self._pos] + int(v)) % R
        self._pos += 1

    def absorb(self, label: str, values) -> None:
        self._absorb_one(sha_to_fr("ezt-absorb-fr/" + label))
        for v in values:
            self._absorb_one(int(v))

    def absorb_packed_gl(self, label: str, values) -> None:
        """Goldilocks values packed three to an Fr element, as the leaves."""
        self.absorb(label, pfr.pack_gl([int(v) for v in values]))

    def challenge_fr(self, label: str) -> int:
        self._absorb_one(sha_to_fr("ezt-challenge-fr/" + label))
        self._permute()
        self._pos = 1
        return self._state[0]

    def challenge_gl(self, label: str) -> int:
        return self.challenge_fr(label) & ((1 << GL_CHALLENGE_BITS) - 1)

    def challenge_indices(self, label: str, n: int, domain_size: int) -> list[int]:
        assert domain_size & (domain_size - 1) == 0
        return [self.challenge_fr(f"{label}/{i}") & (domain_size - 1) for i in range(n)]

    def grind_check(self, nonce: int, bits: int) -> bool:
        """The proof of work: the nonce absorbed, the next challenge's low
        `bits` bits zero."""
        self.absorb("grind", [int(nonce)])
        return self.challenge_fr("grind-ok") & ((1 << bits) - 1) == 0
