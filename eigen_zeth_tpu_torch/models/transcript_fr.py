"""Fiat-Shamir transcript over BN254 Fr — port of
eigen_zeth_tpu/models/transcript_fr.py.

A Poseidon2-Fr duplex sponge: every absorbed element and every squeezed
challenge is one Fr element, so the Groth16 wrap circuit replays it with
permutation gadgets.  Goldilocks challenges are the low 63 bits of a
squeeze (2^63 < p, always canonical); query indices the low log2(n) bits.

`grind` returns the least nonce whose challenge has `bits` low zero bits,
as the JAX package's sequential search does.  Given a CUDA device it tries
the nonces in batches on kernel F (every candidate's absorb-and-squeeze is
one or two permutations of its own state) and keeps the least that passes;
otherwise it searches on the host, one nonce after another.
"""

from __future__ import annotations

import torch

from ..ops import poseidon_fr as pfr

GL_CHALLENGE_BITS = 63
GRIND_BATCH = 1 << 14  # nonces a device batch tries


class TranscriptFr:
    """Duplex sponge over Fr: absorb field elements, squeeze challenges."""

    def __init__(self, domain: str):
        self._state = [0] * pfr.WIDTH
        self._pos = 0
        self._absorb_one(pfr._sha_to_fr("ezt-transcript-fr/" + domain))

    def _permute(self):
        self._state = pfr.perm_host(self._state)
        self._pos = 0

    def _absorb_one(self, v: int):
        if self._pos == pfr.RATE:
            self._permute()
        self._state[self._pos] = (self._state[self._pos] + int(v) % pfr.R) % pfr.R
        self._pos += 1

    def absorb(self, label: str, values) -> None:
        self._absorb_one(pfr._sha_to_fr("ezt-absorb-fr/" + label))
        for v in values:
            self._absorb_one(int(v))

    def absorb_packed_gl(self, label: str, values) -> None:
        """Absorb Goldilocks values packed 3-per-Fr (the Merkle leaves'
        packing, so the circuit shares one unpack gadget)."""
        self.absorb(label, pfr.pack_gl_host([int(v) for v in values]))

    def challenge_fr(self, label: str) -> int:
        self._absorb_one(pfr._sha_to_fr("ezt-challenge-fr/" + label))
        self._permute()
        out = self._state[0]
        self._pos = 1
        return out

    # -- proof-of-work grinding (EthSTARK-style) ---------------------------

    def grind(self, bits: int, *, device) -> int:
        """Find and commit the least nonce whose grind challenge has `bits`
        low zero bits (about 2^bits permutations): on a CUDA `device` in
        batches through kernel F, on the CPU one nonce at a time."""
        base_state, base_pos = list(self._state), self._pos
        if torch.device(device).type == "cuda":
            nonce = _grind_device(base_state, base_pos, bits, torch.device(device))
            self.absorb("grind", [nonce])
            c = self.challenge_fr("grind-ok")
            assert c & ((1 << bits) - 1) == 0
            return nonce
        nonce = 0
        while True:
            self._state, self._pos = list(base_state), base_pos
            self.absorb("grind", [nonce])
            c = self.challenge_fr("grind-ok")
            if c & ((1 << bits) - 1) == 0:
                return nonce
            nonce += 1

    def grind_check(self, nonce: int, bits: int) -> bool:
        """Verifier side: replay the nonce, check the zero bits."""
        self.absorb("grind", [int(nonce)])
        c = self.challenge_fr("grind-ok")
        return c & ((1 << bits) - 1) == 0

    def challenge_gl(self, label: str) -> int:
        """A canonical Goldilocks challenge: low 63 bits of one squeeze."""
        return self.challenge_fr(label) & ((1 << GL_CHALLENGE_BITS) - 1)

    def challenges_gl(self, label: str, n: int) -> list[int]:
        return [self.challenge_gl(f"{label}/{i}") for i in range(n)]

    def challenge_index(self, label: str, domain_size: int) -> int:
        mask = domain_size - 1
        assert domain_size & mask == 0
        return self.challenge_fr(label) & mask

    def challenge_indices(self, label: str, n: int, domain_size: int) -> list[int]:
        return [self.challenge_index(f"{label}/{i}", domain_size) for i in range(n)]


def _grind_device(state: list[int], pos: int, bits: int, device) -> int:
    """The least passing nonce, GRIND_BATCH candidates a batch on kernel F.

    The grind label's absorb does not depend on the nonce and runs here on
    the host; each candidate then adds its nonce into the next lane,
    absorbs the challenge label (permuting first where the rate is full)
    and permutes."""
    assert 0 <= bits <= 63
    t = TranscriptFr.__new__(TranscriptFr)
    t._state, t._pos = list(state), pos
    t._absorb_one(pfr._sha_to_fr("ezt-absorb-fr/grind"))
    if t._pos == pfr.RATE:
        t._permute()
    lane = t._pos
    chal = pfr._sha_to_fr("ezt-challenge-fr/grind-ok")
    mask = (1 << bits) - 1
    start = 0
    while True:
        rows = []
        for nonce in range(start, start + GRIND_BATCH):
            s = list(t._state)
            s[lane] = (s[lane] + nonce) % pfr.R
            rows.append(s)
        if lane + 1 == pfr.RATE:  # the challenge label opens a new block
            mid = pfr.perm_device(pfr.words_from_ints(rows, device))
            rows = [pfr.ints_from_words(mid[i]) for i in range(GRIND_BATCH)]
            at = 0
        else:
            at = lane + 1
        for s in rows:
            s[at] = (s[at] + chal) % pfr.R
        out = pfr.perm_device(pfr.words_from_ints(rows, device))
        low = out[:, 0, 0]
        hit = torch.nonzero((low & mask) == 0)
        if hit.numel():
            return start + int(hit[0, 0])
        start += GRIND_BATCH
