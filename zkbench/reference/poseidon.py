"""Poseidon2 over Goldilocks (t = 12, x^7, 4 + 22 + 4 rounds): the constants
from SHA-256 tags, M_E = circ(2*M4, M4, M4), M_I = 1 + diag(mu).  The host
form on python ints (the Fiat-Shamir transcript) and the batched form on
int64 tensors, lane-major over a (12, N) state, for the sponge, the 2-to-1
compression and a whole Merkle tree's levels."""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from . import gl

WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST = 4
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
ALPHA = 7

M4 = (
    (5, 7, 1, 3),
    (4, 6, 1, 1),
    (1, 3, 5, 7),
    (1, 1, 4, 6),
)


def _sha_to_field(tag: str) -> int:
    """Map a domain-separation tag to a canonical field element."""
    h = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(h, "big") % gl.P


def _is_full_round(r: int) -> bool:
    half = FULL_ROUNDS // 2
    return r < half or r >= half + PARTIAL_ROUNDS


@functools.lru_cache(maxsize=1)
def round_constants() -> list[list[int]]:
    """Per-round additive constants; internal rounds use lane 0 only."""
    out = []
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            out.append([_sha_to_field(f"ezt-poseidon2-gl12/rc/{r}/{i}") for i in range(WIDTH)])
        else:
            out.append([_sha_to_field(f"ezt-poseidon2-gl12/rc/{r}/0")] + [0] * (WIDTH - 1))
    return out


@functools.lru_cache(maxsize=1)
def internal_diag() -> list[int]:
    """mu_i of the internal matrix M_I = allones + diag(mu)."""
    out = []
    for i in range(WIDTH):
        v = _sha_to_field(f"ezt-poseidon2-gl12/diag/{i}")
        assert v != 0, "degenerate diagonal draw"
        out.append(v)
    return out


@functools.lru_cache(maxsize=1)
def external_matrix() -> list[list[int]]:
    """The dense 12x12 external matrix circ(2*M4, M4, M4) (for the verifier
    AIR's matvec constraint; the permutations use the addition chain)."""
    m = [[0] * WIDTH for _ in range(WIDTH)]
    for bi in range(3):
        for bj in range(3):
            mult = 2 if bi == bj else 1
            for i in range(4):
                for j in range(4):
                    m[4 * bi + i][4 * bj + j] = mult * M4[i][j]
    return m


@functools.lru_cache(maxsize=1)
def internal_matrix() -> list[list[int]]:
    """Dense M_I = allones + diag(mu) (for the verifier AIR's matvec constraint)."""
    mu = internal_diag()
    return [[(1 + mu[i]) % gl.P if i == j else 1 for j in range(WIDTH)] for i in range(WIDTH)]


# ---------------------------------------------------------------------------
# host (python int) implementation — verifier + transcript


def _sbox_host(x: int) -> int:
    return pow(x, ALPHA, gl.P)


def _m4_block_host(x: list[int]) -> list[int]:
    t0 = (x[0] + x[1]) % gl.P
    t1 = (x[2] + x[3]) % gl.P
    t2 = (2 * x[1] + t1) % gl.P
    t3 = (2 * x[3] + t0) % gl.P
    t4 = (4 * t1 + t3) % gl.P
    t5 = (4 * t0 + t2) % gl.P
    t6 = (t3 + t5) % gl.P
    t7 = (t2 + t4) % gl.P
    return [t6, t5, t7, t4]


def _external_host(s: list[int]) -> list[int]:
    z = [_m4_block_host(s[4 * b : 4 * b + 4]) for b in range(3)]
    tot = [(z[0][i] + z[1][i] + z[2][i]) % gl.P for i in range(4)]
    out = []
    for b in range(3):
        out += [(z[b][i] + tot[i]) % gl.P for i in range(4)]
    return out


def _internal_host(s: list[int]) -> list[int]:
    mu = internal_diag()
    tot = sum(s) % gl.P
    return [(tot + mu[i] * s[i]) % gl.P for i in range(WIDTH)]


def perm_host(state: list[int]) -> list[int]:
    assert len(state) == WIDTH
    rc = round_constants()
    s = [x % gl.P for x in state]
    s = _external_host(s)
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            s = [_sbox_host((x + c) % gl.P) for x, c in zip(s, rc[r])]
            s = _external_host(s)
        else:
            s = list(s)
            s[0] = _sbox_host((s[0] + rc[r][0]) % gl.P)
            s = _internal_host(s)
    return s


def hash_elements_host(elements: list[int]) -> list[int]:
    """Sponge: absorb rate-8 blocks, squeeze a 4-element digest; the length
    is absorbed into the capacity as domain separation."""
    state = [0] * WIDTH
    state[RATE] = len(elements) % gl.P
    for i in range(0, max(len(elements), 1), RATE):
        block = elements[i : i + RATE]
        for j, v in enumerate(block):
            state[j] = (state[j] + v) % gl.P
        state = perm_host(state)
    return state[:DIGEST]


def hash_two_host(left: list[int], right: list[int]) -> list[int]:
    """2-to-1 digest compression for Merkle interior nodes."""
    state = list(left) + list(right) + [0] * (WIDTH - 2 * DIGEST)
    return perm_host(state)[:DIGEST]


# ---------------------------------------------------------------------------
# device implementation


def _dbl(x):
    return gl.add(x, x)


def _m4(x0, x1, x2, x3):
    """M4 over four row blocks — the Poseidon2 addition chain."""
    t0 = gl.add(x0, x1)
    t1 = gl.add(x2, x3)
    t2 = gl.add(_dbl(x1), t1)
    t3 = gl.add(_dbl(x3), t0)
    t4 = gl.add(_dbl(_dbl(t1)), t3)
    t5 = gl.add(_dbl(_dbl(t0)), t2)
    return gl.add(t3, t5), t5, gl.add(t2, t4), t4


def _external(s: torch.Tensor) -> torch.Tensor:
    """M_E · s on a (12, N) state."""
    b = s.reshape(3, 4, -1)
    z = torch.stack(_m4(b[:, 0], b[:, 1], b[:, 2], b[:, 3]), dim=1)  # (3, 4, N)
    tot = gl.add(gl.add(z[0], z[1]), z[2])
    return gl.add(z, tot[None]).reshape(WIDTH, -1)


def _sbox(x):
    x2 = gl.square(x)
    x4 = gl.square(x2)
    return gl.mul(gl.mul(x4, x2), x)


class Poseidon2(torch.nn.Module):
    """The device permutation; buffers hold the round constants (30, 12)
    and the internal diagonal (12,) as int64 bit patterns."""

    def __init__(self):
        super().__init__()
        rc = np.asarray(round_constants(), dtype=np.uint64)
        mu = np.asarray(internal_diag(), dtype=np.uint64)
        self.register_buffer("rc", torch.from_numpy(rc.view(np.int64)).clone())
        self.register_buffer("diag", torch.from_numpy(mu.view(np.int64)).clone())

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        """Permute (..., 12) states."""
        batch = state.shape[:-1]
        s = state.reshape(-1, WIDTH).T.contiguous()  # lane-major (12, N)
        s = _external(s)
        for r in range(N_ROUNDS):
            if _is_full_round(r):
                s = _external(_sbox(gl.add(s, self.rc[r][:, None])))
            else:
                s0 = _sbox(gl.add(s[0], self.rc[r][0]))
                s = torch.cat([s0[None], s[1:]], dim=0)
                t = gl.add(s[0:6], s[6:12])
                t = gl.add(t[0:3], t[3:6])
                tot = gl.add(gl.add(t[0], t[1]), t[2])
                s = gl.add(tot[None], gl.mul(s, self.diag[:, None]))
        return s.T.reshape(batch + (WIDTH,))


_MODULES: dict = {}


def _module(device) -> Poseidon2:
    key = torch.device(device)
    if key not in _MODULES:
        _MODULES[key] = Poseidon2().to(key)
    return _MODULES[key]


# On a CUDA device a permutation is some 7,000 elementwise launches, so a
# batch of at most GRAPH_MOST states replays the module's launches, captured
# once per batch size, as one CUDA graph: the same operations on the same
# values, without the host's launch cost.
GRAPH_MOST = 1 << 15
_GRAPHS: dict = {}


def _graph(n: int, device):
    """(graph, its input, its output) of the permutation of n states."""
    key = (n, torch.device(device))
    if key not in _GRAPHS:
        mod = _module(device)
        x = torch.zeros((n, WIDTH), dtype=torch.int64, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            mod(x)  # the first run outside the capture, as CUDA graphs ask
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = mod(x)
        _GRAPHS[key] = (g, x, y)
    return _GRAPHS[key]


def perm(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of (..., 12) int64 states on their device."""
    flat = state.reshape(-1, WIDTH)
    if not flat.is_cuda or flat.shape[0] > GRAPH_MOST:
        return _module(state.device)(state)
    g, x, y = _graph(flat.shape[0], flat.device)
    x.copy_(flat)
    g.replay()
    return y.clone().reshape(state.shape)


def hash_elements(elements: torch.Tensor) -> torch.Tensor:
    """Sponge over the last axis, (..., k) -> (..., 4) digests: one
    permutation of the whole batch per block of 8 elements."""
    k = elements.shape[-1]
    batch = elements.shape[:-1]
    state = gl.zeros(batch + (WIDTH,), elements.device)
    state[..., RATE] = k % gl.P
    for i in range(max(1, (k + RATE - 1) // RATE)):
        block = elements[..., i * RATE : (i + 1) * RATE]
        w = block.shape[-1]
        state = torch.cat([gl.add(state[..., :w], block), state[..., w:]], dim=-1)
        state = perm(state)
    return state[..., :DIGEST]


def hash_two(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 compression: (..., 4) x (..., 4) -> (..., 4)."""
    pad = gl.zeros(left.shape[:-1] + (WIDTH - 2 * DIGEST,), left.device)
    return perm(torch.cat([left, right, pad], dim=-1))[..., :DIGEST]


def merkle_levels(level: torch.Tensor) -> list[torch.Tensor]:
    """Every Merkle level above (..., n, 4) digests, n a power of two: one
    `hash_two` per level, even digests with odd."""
    n = level.shape[-2]
    assert n >= 1 and n & (n - 1) == 0
    out = []
    cur = level
    while cur.shape[-2] > 1:
        cur = hash_two(cur[..., 0::2, :], cur[..., 1::2, :])
        out.append(cur)
    return out
