"""Keccak-256 (Ethereum's padding 0x01 … 0x80) — host implementation.

Copy of `keccak256_host` and its permutation from eigen_zeth_tpu/ops/keccak.py;
the synthetic executor derives block payloads and state roots with it."""

from __future__ import annotations

RATE_BYTES = 136  # keccak256: rate 1088 bits, capacity 512
ROUNDS = 24

# Round constants (64-bit), standard Keccak values.
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] (standard table, indexed [x + 5*y]).
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

_PI_DEST = [0] * 25  # pi: B[y, 2x+3y] = A[x, y]; dest index for each src
for _x in range(5):
    for _y in range(5):
        _PI_DEST[_x + 5 * _y] = _y + 5 * ((2 * _x + 3 * _y) % 5)


# ---------------------------------------------------------------------------
# host reference (python ints)


def _rotl64(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & 0xFFFFFFFFFFFFFFFF


def keccak_f_host(lanes: list[int]) -> list[int]:
    a = list(lanes)
    for rnd in range(ROUNDS):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for i in range(25):
            b[_PI_DEST[i]] = _rotl64(a[i], _ROT[i])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            & 0xFFFFFFFFFFFFFFFF
            for i in range(25)
        ]
        # iota
        a[0] ^= _RC[rnd]
    return a


def _pad(data: bytes) -> bytes:
    pad_len = RATE_BYTES - (len(data) % RATE_BYTES)
    padded = bytearray(data) + bytearray(pad_len)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    return bytes(padded)


def keccak256_host(data: bytes) -> bytes:
    lanes = [0] * 25
    padded = _pad(data)
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off : off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = keccak_f_host(lanes)
    out = b"".join(lanes[i].to_bytes(8, "little") for i in range(4))
    return out
