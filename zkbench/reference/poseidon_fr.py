"""Poseidon2 over BN254 Fr (t = 12, rate 11, capacity 1, x^5, 4 + 68 + 4
rounds): the constants from SHA-256 tags, M_E = circ(2*M4, M4, M4), M_I =
1 + diag(mu), internal-round constants on lane 0 only.  Goldilocks values
ride three to an Fr element (64 bits each).

Two forms:
  * host python ints (`perm_host`, `hash_elements_host`, `hash_two_host`):
    the Fr transcript and single checks;
  * batched on int64 tensors (`perm`, `hash_rows`, `compress`): an Fr value
    is 10 limbs of 29 bits, little end first, on the last axis; the rounds
    run in Montgomery form (R = 2^290), every product one schoolbook
    multiplication and a word-by-word reduction.  A limb product is below
    2^58 and a column of the product and the reduction sums at most 19 of
    them, under 2^63.  Between products a value stays below 2^271, so every
    product's reduction ends below 2r; the last step brings it below r.
"""

from __future__ import annotations

import functools
import hashlib

import torch

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
WIDTH = 12
RATE = 11
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 68
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
GL_PACK = 3


def sha_to_fr(tag: str) -> int:
    return int.from_bytes(hashlib.sha256(tag.encode()).digest(), "big") % R


def _is_full_round(r: int) -> bool:
    half = FULL_ROUNDS // 2
    return r < half or r >= half + PARTIAL_ROUNDS


@functools.lru_cache(maxsize=1)
def round_constants() -> list[list[int]]:
    out = []
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            out.append([sha_to_fr(f"ezt-poseidon2-fr12/rc/{r}/{i}") for i in range(WIDTH)])
        else:
            out.append([sha_to_fr(f"ezt-poseidon2-fr12/rc/{r}/0")] + [0] * (WIDTH - 1))
    return out


@functools.lru_cache(maxsize=1)
def internal_diag() -> list[int]:
    """mu_i; a draw of 0 or -1 would be drawn again under a further tag
    (none is)."""
    out = []
    for i in range(WIDTH):
        v = sha_to_fr(f"ezt-poseidon2-fr12/diag/{i}")
        k = 0
        while v in (0, R - 1):
            k += 1
            v = sha_to_fr(f"ezt-poseidon2-fr12/diag/{i}/{k}")
        out.append(v)
    return out


def sponge_capacity(tag: str, length: int) -> int:
    """The capacity lane of a sponge over `length` elements under `tag`."""
    return (sha_to_fr("ezt-pfr-sponge/" + tag) + length) % R


NODE = sha_to_fr("ezt-pfr-sponge/node")


# ---------------------------------------------------------------------------
# host form (python ints)


def _m4_host(x):
    """M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6)) as the
    Poseidon2 addition chain."""
    t0 = x[0] + x[1]
    t1 = x[2] + x[3]
    t2 = 2 * x[1] + t1
    t3 = 2 * x[3] + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    return [t3 + t5, t5, t2 + t4, t4]


def _external_host(s):
    z = [_m4_host(s[4 * b : 4 * b + 4]) for b in range(3)]
    tot = [z[0][i] + z[1][i] + z[2][i] for i in range(4)]
    return [(z[b][i] + tot[i]) % R for b in range(3) for i in range(4)]


def perm_host(state: list[int]) -> list[int]:
    assert len(state) == WIDTH
    rc, mu = round_constants(), internal_diag()
    s = _external_host([v % R for v in state])
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            s = _external_host([pow(v + c, 5, R) for v, c in zip(s, rc[r])])
        else:
            s = [pow(s[0] + rc[r][0], 5, R)] + s[1:]
            tot = sum(s)
            s = [(tot + m * v) % R for m, v in zip(mu, s)]
    return s


def hash_elements_host(elements: list[int], tag: str = "leaf") -> int:
    """The sponge: RATE elements a block added into the state, then a
    permutation; the digest is lane 0."""
    s = [0] * WIDTH
    s[WIDTH - 1] = sponge_capacity(tag, len(elements))
    for i in range(0, len(elements), RATE):
        for j, v in enumerate(elements[i : i + RATE]):
            s[j] = (s[j] + v) % R
        s = perm_host(s)
    return s[0]


def hash_two_host(left: int, right: int) -> int:
    """The 2-to-1 compression of a Merkle node."""
    s = [left % R, right % R] + [0] * (WIDTH - 3) + [NODE]
    return perm_host(s)[0]


def pack_gl(values) -> list[int]:
    """Goldilocks values (canonical) three to an Fr element, 64 bits each."""
    out = []
    for i in range(0, len(values), GL_PACK):
        v = 0
        for j, x in enumerate(values[i : i + GL_PACK]):
            v |= int(x) << (64 * j)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# batched form: Fr values as 10 limbs of 29 bits in int64 tensors

BITS = 29
LIMBS = 10
MASK = (1 << BITS) - 1
MONT = 1 << (BITS * LIMBS)  # the Montgomery radix
NPRIME = (-pow(R, -1, 1 << BITS)) % (1 << BITS)
R_LIMBS = 9  # r < 2^261: its tenth limb is zero


def limbs_of(v: int) -> list[int]:
    return [(v >> (BITS * i)) & MASK for i in range(LIMBS)]


def from_ints(values, device) -> torch.Tensor:
    """Python ints (nested lists) -> (..., 10) limbs of their values mod r."""
    def walk(v):
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        return limbs_of(int(v) % R)

    return torch.tensor(walk(values), dtype=torch.int64, device=device)


def to_ints(x: torch.Tensor) -> list:
    """(n, 10) limbs (normalised) -> n python ints."""
    return [sum(int(l) << (BITS * i) for i, l in enumerate(row))
            for row in x.reshape(-1, LIMBS).cpu().tolist()]


def normalise(x: torch.Tensor) -> torch.Tensor:
    """Carry every limb's excess into the next; the last limb keeps its
    own.  Limbs non-negative."""
    out, carry = [], None
    for i in range(LIMBS):
        v = x[..., i] if carry is None else x[..., i] + carry
        if i < LIMBS - 1:
            carry = v >> BITS
            v = v & MASK
        out.append(v)
    return torch.stack(out, dim=-1)


def carry(x: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Every limb's excess carried one limb up, `passes` times at once (the
    last limb keeps its own): the same value, each limb below 2^29 plus
    what the last pass carried in.  Two passes bring limbs below 2^35 to at
    most 2^29, three those below 2^63."""
    keep, carried = _carry_masks(x.device)
    for _ in range(passes):
        x = (x & keep) + torch.roll((x >> BITS) * carried, 1, dims=-1)
    return x


_MASKS: dict = {}


def _carry_masks(device):
    """(the bits a limb keeps, which limbs pass their excess up): every limb
    keeps its low 29 bits and passes the rest, but the last keeps all."""
    key = torch.device(device)
    if key not in _MASKS:
        _MASKS[key] = (torch.tensor([MASK] * (LIMBS - 1) + [-1], device=key),
                       torch.tensor([1] * (LIMBS - 1) + [0], device=key))
    return _MASKS[key]


def _lead(x: torch.Tensor) -> tuple:
    return tuple(x.shape[:-1])


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·2^-290 mod r, below 2r, for a, b with limbs at most 2^29 and
    a·b < 2^290·r (broadcasting over the leading axes); the result's limbs
    at most 2^29."""
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 10, 10), each below 2^58
    lead = _lead(prod[..., 0])
    # the product's columns: row i shifted right by i, then summed
    p = torch.nn.functional.pad(prod, (0, LIMBS)).reshape(lead + (2 * LIMBS * LIMBS,))
    p = p[..., : LIMBS * (2 * LIMBS - 1)].reshape(lead + (LIMBS, 2 * LIMBS - 1))
    # the reduction, limb by limb, on the columns laid out first: (20, ...)
    t = torch.nn.functional.pad(p.sum(dim=-2), (0, 1)).movedim(-1, 0).contiguous()
    r_limbs = _consts(t.device)["r"].reshape((R_LIMBS,) + (1,) * (t.dim() - 1))
    for i in range(LIMBS):
        ti = t[i]
        m = (ti * NPRIME) & MASK  # the low 29 bits survive the product's wrap
        t[i : i + R_LIMBS].addcmul_(m, r_limbs)
        t[i + 1] += ti >> BITS
    return carry(t[LIMBS:].movedim(0, -1), 3)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """A value below 2r -> below r, normalised."""
    x = normalise(x)
    r_limbs = _consts(x.device)["r_all"]
    out, borrow = [], torch.zeros_like(x[..., 0])
    for i in range(LIMBS):
        d = x[..., i] - r_limbs[i] - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d + (borrow << BITS))
    d = torch.stack(out, dim=-1)
    return torch.where((borrow == 0).unsqueeze(-1), d, x)


_CONSTS: dict = {}


def _consts(device) -> dict:
    key = torch.device(device)
    if key not in _CONSTS:
        def mont(v):
            return (v * MONT) % R

        rc = round_constants()
        full = [[mont(c) for c in rc[r]] for r in range(N_ROUNDS) if _is_full_round(r)]
        part = [mont(rc[r][0]) for r in range(N_ROUNDS) if not _is_full_round(r)]
        _CONSTS[key] = {
            "r": torch.tensor(limbs_of(R)[:R_LIMBS], dtype=torch.int64, device=key),
            "r_all": limbs_of(R),
            "full": from_ints(full, key),  # (8, 12, 10)
            "part": from_ints(part, key),  # (68, 10)
            # the internal diagonal, then 1, in Montgomery form: (13, 10)
            "mu1": from_ints([mont(m) for m in internal_diag()] + [mont(1)], key),
            "r2": from_ints(MONT * MONT % R, key),
            "unit": from_ints(1, key),
        }
    return _CONSTS[key]


def _external(s: torch.Tensor) -> torch.Tensor:
    """M_E over (..., 12, 10) limbs: below 64 times the largest input."""
    b = s.reshape(_lead(s)[:-1] + (3, 4, LIMBS))
    x0, x1, x2, x3 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = 2 * x1 + t1
    t3 = 2 * x3 + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    z = torch.stack([t3 + t5, t5, t2 + t4, t4], dim=-2)  # (..., 3, 4, 10)
    return carry((z + z.sum(dim=-3, keepdim=True)).reshape(s.shape))


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = mont_mul(x, x)
    return mont_mul(mont_mul(x2, x2), x)


def perm(state: torch.Tensor) -> torch.Tensor:
    """The permutation of (..., 12, 10) limbs (values below 2^271) ->
    (..., 12, 10) canonical limbs."""
    c = _consts(state.device)
    s = _external(mont_mul(state, c["r2"]))  # into Montgomery form, below 128r
    full = iter(c["full"])
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            s = _external(_sbox(carry(s + next(full))))  # below 128r
        else:
            p = r - FULL_ROUNDS // 2
            s0 = _sbox(carry(s[..., 0, :] + c["part"][p]))
            s = torch.cat([s0.unsqueeze(-2), s[..., 1:, :]], dim=-2)
            # one product for the diagonal and the sum's reduction (by one):
            # each below 2r, so the lanes stay below 4r
            t = mont_mul(torch.cat([s, carry(s.sum(dim=-2, keepdim=True))], dim=-2), c["mu1"])
            s = carry(t[..., :WIDTH, :] + t[..., WIDTH:, :])
    return canonical(mont_mul(s, c["unit"]))


def _zeros_state(lead: tuple, device) -> torch.Tensor:
    return torch.zeros(lead + (WIDTH, LIMBS), dtype=torch.int64, device=device)


def hash_rows(rows: torch.Tensor, lengths: list | None = None,
              tag: str = "leaf") -> torch.Tensor:
    """The sponge over each row of (n, k, 10) limbs (values below r) ->
    (n, 10) digests.  `lengths` gives each row's own length where the rows
    are zero-padded to k: its capacity lane is its own, and its state is
    left as it is after its own last block."""
    n, k = rows.shape[0], rows.shape[1]
    lengths = [k] * n if lengths is None else lengths
    s = _zeros_state((n,), rows.device)
    s[:, WIDTH - 1] = from_ints([sponge_capacity(tag, m) for m in lengths], rows.device)
    blocks = torch.tensor([-(-m // RATE) for m in lengths], device=rows.device)
    for b, i in enumerate(range(0, k, RATE)):
        blk = rows[:, i : i + RATE]
        w = blk.shape[1]
        nxt = perm(torch.cat([carry(s[:, :w] + blk), s[:, w:]], dim=1))
        s = torch.where((blocks > b).reshape(-1, 1, 1), nxt, s)
    return s[:, 0]


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The Merkle node over (..., 10) limbs: (left, right) -> digest."""
    s = _zeros_state(_lead(left), left.device)
    s[..., 0, :] = left
    s[..., 1, :] = right
    s[..., WIDTH - 1, :] = from_ints(NODE, left.device)
    return perm(s)[..., 0, :]


def pack_gl_limbs(values: torch.Tensor) -> torch.Tensor:
    """(..., k) canonical Goldilocks values (their uint64 bits in int64) ->
    (..., ceil(k/3), 10) limbs of the packed Fr elements."""
    k = values.shape[-1]
    n = -(-k // GL_PACK)
    if n * GL_PACK != k:
        pad = values.new_zeros(values.shape[:-1] + (n * GL_PACK - k,))
        values = torch.cat([values, pad], dim=-1)
    v = values.reshape(values.shape[:-1] + (n, GL_PACK))
    # the six 32-bit halves sit at bits 32·h, which is limb h (29·h <= 32·h
    # < 29·(h+1) + 29) shifted by 3·h: one half a limb, below 2^47
    halves = torch.stack([v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF], dim=-1)
    halves = halves.reshape(v.shape[:-1] + (2 * GL_PACK,))
    shift = torch.arange(0, 3 * 2 * GL_PACK, 3, device=values.device)
    low = halves << shift
    return normalise(torch.cat([low, torch.zeros_like(low[..., : LIMBS - 2 * GL_PACK])], dim=-1))
