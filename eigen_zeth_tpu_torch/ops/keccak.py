"""Keccak-256 (Ethereum's padding 0x01 … 0x80) — port of
eigen_zeth_tpu/ops/keccak.py.

`keccak256_host` and its permutation are copies of the JAX package's; every
Keccak of the node (sealing, tries, signatures, settlement) takes it, as
there.  `keccak256` is the batched form over same-length messages: kernel G
on the card, `absorb_plain` on the CPU, where the 25 lanes are int64
tensors (`>>` is arithmetic on int64, so a rotation masks what it shifts
in).  As in the JAX package, no path of the node calls it, so torch is
imported only by the batched form: the host Keccak loads no tensor library.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

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


# ---------------------------------------------------------------------------
# batched keccak256 of same-length messages: kernel G on the card
# (ops/kernels.py, csrc/keccak.cu), the plain version below on the CPU

def _i64(v: int) -> int:
    """A 64-bit word's bit pattern as int64."""
    return v - (1 << 64) if v >> 63 else v


_RC_I64 = [_i64(v) for v in _RC]


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64 words left by a constant: `>>` is arithmetic on int64,
    so the bits shifted in from the top are masked off."""
    if r == 0:
        return x
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_f_plain(a: list) -> list:
    """Keccak-f[1600] on 25 int64 lane tensors of one batch shape (the
    plain version of kernel G's permutation)."""
    a = list(a)
    for rnd in range(ROUNDS):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl_t(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for i in range(25):
            b[_PI_DEST[i]] = _rotl_t(a[i], _ROT[i])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] = a[0] ^ _RC_I64[rnd]
    return a


def absorb_plain(lanes: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G: padded lanes (nblocks·17, n) int64 ->
    the digests' four lanes (4, n)."""
    import torch

    n = lanes.shape[1]
    a = [torch.zeros(n, dtype=torch.int64, device=lanes.device) for _ in range(25)]
    for blk in range(lanes.shape[0] // 17):
        for i in range(17):
            a[i] = a[i] ^ lanes[blk * 17 + i]
        a = keccak_f_plain(a)
    return torch.stack(a[:4])


def pad_lanes(messages: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 messages -> their padded lanes (nblocks·17, N) int64
    (Keccak-original padding 0x01 ... 0x80, little-endian words), on the
    messages' device."""
    import torch

    n, length = messages.shape
    pad = RATE_BYTES - length % RATE_BYTES
    padded = torch.zeros((n, length + pad), dtype=torch.uint8, device=messages.device)
    padded[:, :length] = messages
    padded[:, length] ^= 0x01
    padded[:, -1] ^= 0x80
    return padded.view(torch.int64).t().contiguous()


def keccak256(messages) -> torch.Tensor:
    """Batch keccak256: (N, L) uint8 same-length messages (a tensor, or
    anything numpy reads; one message may be 1-D) -> (N, 32) uint8 on the
    messages' device.  On a CUDA tensor one launch of kernel G absorbs every
    block; on the CPU the plain version runs.  Padding and packing are
    tensor code on the messages' device."""
    import numpy as np
    import torch

    if not isinstance(messages, torch.Tensor):
        messages = torch.from_numpy(np.array(messages, dtype=np.uint8))
    if messages.dtype is not torch.uint8:
        raise TypeError(f"keccak256: expected uint8 messages, got {messages.dtype}")
    if messages.dim() == 1:
        messages = messages[None]
    lanes = pad_lanes(messages)
    if lanes.is_cuda:
        from . import kernels

        out = kernels.keccak256_lanes(lanes)
    else:
        out = absorb_plain(lanes)
    return out.t().contiguous().view(torch.uint8)
