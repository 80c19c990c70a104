"""The Fiat-Shamir transcript: a Poseidon2 duplex sponge over Goldilocks on
host python ints."""

from __future__ import annotations

from . import gl, poseidon
from .poseidon import RATE, WIDTH, _sha_to_field


class Transcript:
    """Duplex sponge: absorb field elements, squeeze challenges.  Every
    call is framed with a domain-separation tag."""

    def __init__(self, domain: str):
        self._state = [0] * WIDTH
        self._pos = 0
        self._absorb_one(_sha_to_field("ezt-transcript/" + domain))

    def _permute(self):
        self._state = poseidon.perm_host(self._state)
        self._pos = 0

    def _absorb_one(self, v: int):
        if self._pos == RATE:
            self._permute()
        self._state[self._pos] = (self._state[self._pos] + v % gl.P) % gl.P
        self._pos += 1

    def absorb(self, label: str, values) -> None:
        self._absorb_one(_sha_to_field("ezt-absorb/" + label))
        for v in values:
            self._absorb_one(int(v))

    def challenge(self, label: str) -> int:
        return self.challenges(label, 1)[0]

    def challenges(self, label: str, n: int) -> list[int]:
        self._absorb_one(_sha_to_field("ezt-challenge/" + label))
        self._permute()
        out = []
        pos = 0
        while len(out) < n:
            if pos == RATE:
                self._permute()
                pos = 0
            out.append(self._state[pos])
            pos += 1
        self._pos = pos
        return out

    def challenge_indices(self, label: str, n: int, domain_size: int) -> list[int]:
        """n query indices in [0, domain_size); domain_size a power of 2."""
        mask = domain_size - 1
        assert domain_size & mask == 0
        return [c & mask for c in self.challenges(label, n)]
