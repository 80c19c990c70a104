"""Poseidon2 over BN254 Fr — port of eigen_zeth_tpu/ops/poseidon_fr.py.

The SNARK-friendly hash of the final wrap: the wrap-profile attestation
(models/air_wrap.py) commits with Merkle trees and a Fiat-Shamir transcript
over Fr, so that the Groth16 circuit (models/wrap_circuit.py) verifies it
with ~492 constraints a permutation.

The instance (the JAX package pins it; the reference publishes none): width
12 over Fr, rate 11, capacity 1, S-box x^5, R_F = 8 (4 + 4), R_P = 68,
external matrix circ(2·M4, M4, M4), internal matrix allones + diag(mu_i),
constants SHA-256("ezt-poseidon2-fr12/...") mod r, internal-round constants
on lane 0 only.  Goldilocks values ride 3 to an Fr element.

Three forms, bit-identical:
  * host python ints (`perm_host`, `hash_elements_host`, `hash_two_host`,
    `pack_gl_host`): the transcript and Merkle path checks;
  * the device form (`perm_device`, `pack_gl_device`): on a CUDA tensor it
    launches kernel F (csrc/poseidon2_fr.cu, through ops/kernels.py); on a
    CPU tensor it runs the plain versions below, a PyTorch copy of the JAX
    package's `_perm_device_run` on the port's MontCtx for the Fr modulus;
  * the R1CS gadget (models/r1cs_builder.py).

An Fr value on the device is four 64-bit words, little end first, in an
int64 tensor (..., 4), canonical (< r) and in regular (not Montgomery)
form: kernel F converts on the way in and out.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ..utils import profiling
from . import bn254
from .bigint import L

R = bn254.R  # BN254 Fr modulus

WIDTH = 12
RATE = 11
CAPACITY = 1
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 68
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
ALPHA = 5

M4 = (
    (5, 7, 1, 3),
    (4, 6, 1, 1),
    (1, 3, 5, 7),
    (1, 1, 4, 6),
)

GL_PACK = 3  # Goldilocks values per Fr element
WORDS = 4  # 64-bit words of an Fr value on the device


def _sha_to_fr(tag: str) -> int:
    h = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(h, "big") % R


def _is_full_round(r: int) -> bool:
    half = FULL_ROUNDS // 2
    return r < half or r >= half + PARTIAL_ROUNDS


@functools.lru_cache(maxsize=1)
def round_constants() -> list[list[int]]:
    out = []
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            out.append([_sha_to_fr(f"ezt-poseidon2-fr12/rc/{r}/{i}") for i in range(WIDTH)])
        else:
            out.append([_sha_to_fr(f"ezt-poseidon2-fr12/rc/{r}/0")] + [0] * (WIDTH - 1))
    return out


@functools.lru_cache(maxsize=1)
def internal_diag() -> list[int]:
    """mu_i for M_I = allones + diag(mu); resample on 0/-1 (none occur)."""
    out = []
    for i in range(WIDTH):
        v = _sha_to_fr(f"ezt-poseidon2-fr12/diag/{i}")
        k = 0
        while v in (0, R - 1):  # pragma: no cover - never hit for this tag set
            k += 1
            v = _sha_to_fr(f"ezt-poseidon2-fr12/diag/{i}/{k}")
        out.append(v)
    return out


def sponge_capacity(tag: str, length: int) -> int:
    """The capacity lane a sponge of `length` elements under `tag` starts
    from (`hash_elements_host`)."""
    return (_sha_to_fr("ezt-pfr-sponge/" + tag) + length) % R


# ---------------------------------------------------------------------------
# host scalar implementation (python ints)


def _sbox_host(x: int) -> int:
    x2 = x * x % R
    x4 = x2 * x2 % R
    return x4 * x % R


def _m4_block_host(x: list[int]) -> list[int]:
    t0 = (x[0] + x[1]) % R
    t1 = (x[2] + x[3]) % R
    t2 = (2 * x[1] + t1) % R
    t3 = (2 * x[3] + t0) % R
    t4 = (4 * t1 + t3) % R
    t5 = (4 * t0 + t2) % R
    t6 = (t3 + t5) % R
    t7 = (t2 + t4) % R
    return [t6, t5, t7, t4]


def _external_host(s: list[int]) -> list[int]:
    blocks = [_m4_block_host(s[i : i + 4]) for i in range(0, WIDTH, 4)]
    sums = [sum(b[j] for b in blocks) % R for j in range(4)]
    return [(blocks[i // 4][i % 4] + sums[i % 4]) % R for i in range(WIDTH)]


def _internal_host(s: list[int]) -> list[int]:
    mu = internal_diag()
    tot = sum(s) % R
    return [(tot + mu[i] * s[i]) % R for i in range(WIDTH)]


def perm_host(state: list[int]) -> list[int]:
    assert len(state) == WIDTH
    s = [v % R for v in state]
    rc = round_constants()
    s = _external_host(s)  # initial linear layer
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            s = [(v + c) % R for v, c in zip(s, rc[r])]
            s = [_sbox_host(v) for v in s]
            s = _external_host(s)
        else:
            s = [(s[0] + rc[r][0]) % R] + s[1:]
            s = [_sbox_host(s[0])] + s[1:]
            s = _internal_host(s)
    return s


def hash_elements_host(elements: list[int], tag: str = "leaf") -> int:
    """Sponge over RATE lanes; the capacity lane is seeded with a domain tag
    plus the input length.  Digest = one Fr element (state[0])."""
    s = [0] * WIDTH
    s[WIDTH - 1] = sponge_capacity(tag, len(elements))
    for i in range(0, len(elements), RATE):
        blk = elements[i : i + RATE]
        for j, v in enumerate(blk):
            s[j] = (s[j] + v % R) % R
        s = perm_host(s)
    return s[0]


def hash_two_host(left: int, right: int) -> int:
    """2-to-1 Merkle compression: one permutation."""
    s = [0] * WIDTH
    s[0] = left % R
    s[1] = right % R
    s[WIDTH - 1] = _sha_to_fr("ezt-pfr-sponge/node")
    return perm_host(s)[0]


def pack_gl_host(values: list[int]) -> list[int]:
    """Pack canonical Goldilocks values 3-per-Fr (64 bits each)."""
    out = []
    for i in range(0, len(values), GL_PACK):
        blk = values[i : i + GL_PACK]
        v = 0
        for j, x in enumerate(blk):
            assert 0 <= int(x) < (1 << 64)
            v |= int(x) << (64 * j)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# host batches (numpy arrays of python ints): the CPU's Merkle commits


def _external_batch(s):
    x = [s[:, i] for i in range(WIDTH)]
    blocks = []
    for b in range(0, WIDTH, 4):
        x0, x1, x2, x3 = x[b : b + 4]
        t0 = (x0 + x1) % R
        t1 = (x2 + x3) % R
        t2 = (2 * x1 + t1) % R
        t3 = (2 * x3 + t0) % R
        t4 = (4 * t1 + t3) % R
        t5 = (4 * t0 + t2) % R
        blocks.append([(t3 + t5) % R, t5, (t2 + t4) % R, t4])
    sums = [(blocks[0][j] + blocks[1][j] + blocks[2][j]) % R for j in range(4)]
    return np.stack([(blocks[i // 4][i % 4] + sums[i % 4]) % R for i in range(WIDTH)], axis=1)


def _sbox_batch(x):
    x2 = x * x % R
    x4 = x2 * x2 % R
    return x4 * x % R


def perm_host_batch(states: np.ndarray) -> np.ndarray:
    """`perm_host` over an (N, 12) object array of python ints, every
    operation across the N states at once."""
    rc = round_constants()
    mu = np.asarray(internal_diag(), dtype=object)
    s = _external_batch(np.asarray(states, dtype=object) % R)
    for r in range(N_ROUNDS):
        if _is_full_round(r):
            s = _external_batch(_sbox_batch((s + np.asarray(rc[r], dtype=object)) % R))
        else:
            s = s.copy()
            s[:, 0] = _sbox_batch((s[:, 0] + rc[r][0]) % R)
            tot = s.sum(axis=1) % R
            s = (tot[:, None] + mu[None, :] * s) % R
    return s


def hash_rows_host(packed: np.ndarray, tag: str = "leaf") -> np.ndarray:
    """`hash_elements_host` of every row of an (N, k) object array."""
    n, k = packed.shape
    s = np.zeros((n, WIDTH), dtype=object)
    s[:, WIDTH - 1] = sponge_capacity(tag, k)
    for b in range(0, k, RATE):
        blk = packed[:, b : b + RATE] % R
        s[:, : blk.shape[1]] = (s[:, : blk.shape[1]] + blk) % R
        s = perm_host_batch(s)
    return s[:, 0]


def merkle_levels_host(digests: np.ndarray) -> list:
    """Every level above N leaf digests (object array), `hash_two_host` a
    pair."""
    node = _sha_to_fr("ezt-pfr-sponge/node")
    out, cur = [], np.asarray(digests, dtype=object)
    while len(cur) > 1:
        s = np.zeros((len(cur) // 2, WIDTH), dtype=object)
        s[:, 0], s[:, 1], s[:, WIDTH - 1] = cur[0::2], cur[1::2], node
        cur = perm_host_batch(s)[:, 0]
        out.append(cur)
    return out


def pack_gl_rows_host(rows: np.ndarray) -> np.ndarray:
    """(N, k) canonical Goldilocks values (uint64) -> (N, ceil(k/3)) object
    array of packed Fr values (`pack_gl_host` of every row)."""
    rows = np.atleast_2d(np.asarray(rows, dtype=np.uint64))
    n, k = rows.shape
    n_fr = -(-k // GL_PACK)
    padded = np.zeros((n, n_fr * GL_PACK), dtype=np.uint64)
    padded[:, :k] = rows
    v = padded.astype(object).reshape(n, n_fr, GL_PACK)
    return v[:, :, 0] + (v[:, :, 1] << 64) + (v[:, :, 2] << 128)


# ---------------------------------------------------------------------------
# device words <-> python ints


def words_from_ints(values, device) -> torch.Tensor:
    """Python ints, or nested lists of them -> (..., 4) int64 words of their
    values mod r."""
    shape, flat = [], []

    def walk(v, depth):
        if isinstance(v, (list, tuple, np.ndarray)):
            if len(shape) == depth:
                shape.append(len(v))
            for x in v:
                walk(x, depth + 1)
        else:
            flat.append(int(v) % R)

    walk(values, 0)
    buf = b"".join(v.to_bytes(8 * WORDS, "little") for v in flat)
    words = np.frombuffer(buf, dtype="<i8").reshape(tuple(shape) + (WORDS,))
    return torch.from_numpy(words.copy()).to(device)


def ints_from_words(words: torch.Tensor) -> list:
    """(n, 4) int64 words -> a list of n python ints (one transfer)."""
    with profiling.device_read(words):
        host = np.ascontiguousarray(words.detach().reshape(-1, WORDS).cpu().numpy().astype("<i8"))
    buf = host.tobytes()
    step = 8 * WORDS
    return [int.from_bytes(buf[i : i + step], "little") for i in range(0, len(buf), step)]


# ---------------------------------------------------------------------------
# the plain versions of kernel F: MontCtx limb planes on int32 tensors


@functools.lru_cache(maxsize=1)
def _ctx():
    return bn254.fr()


_consts_dev: dict = {}


def _device_consts(device):
    """Montgomery-form constants as (16, ...) limbs on `device`: rc_full
    (16, 8, 12, 1), rc_part (16, 68, 1), mu (16, 12, 1), R^2 and 1."""
    key = torch.device(device)
    if key not in _consts_dev:
        ctx = _ctx()
        rc = round_constants()
        full = [rc[r] for r in range(N_ROUNDS) if _is_full_round(r)]
        part = [rc[r][0] for r in range(N_ROUNDS) if not _is_full_round(r)]
        _consts_dev[key] = (
            ctx.from_int(full, key)[..., None],
            ctx.from_int(part, key)[..., None],
            ctx.from_int(internal_diag(), key)[..., None],
            ctx.from_int([ctx.R2_mod], key, mont=False),
            ctx.from_int([1], key, mont=False),
        )
    return _consts_dev[key]


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(..., 4) int64 words -> (16, ...) int32 limbs of the same value."""
    shifts = torch.arange(0, 64, 16, device=words.device, dtype=torch.int64)
    limbs = (words[..., :, None] >> shifts) & 0xFFFF  # (..., 4, 4)
    limbs = limbs.reshape(words.shape[:-1] + (L,))
    return limbs.movedim(-1, 0).to(torch.int32).contiguous()


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(16, ...) limbs -> (..., 4) int64 words (two's complement bits)."""
    x = limbs.to(torch.int64).movedim(0, -1).reshape(limbs.shape[1:] + (WORDS, 4))
    return x[..., 0] | (x[..., 1] << 16) | (x[..., 2] << 32) | (x[..., 3] << 48)


def _to_mont(x: torch.Tensor) -> torch.Tensor:
    r2 = _device_consts(x.device)[3]
    return _ctx().mont_mul_plain(x, r2.reshape((L,) + (1,) * (x.dim() - 1)))


def _from_mont(x: torch.Tensor) -> torch.Tensor:
    one = _device_consts(x.device)[4]
    return _ctx().mont_mul_plain(x, one.reshape((L,) + (1,) * (x.dim() - 1)))


def _sbox_plain(ctx, x):
    x2 = ctx.mont_mul_plain(x, x)
    x4 = ctx.mont_mul_plain(x2, x2)
    return ctx.mont_mul_plain(x4, x)


def _external_plain(ctx, s):
    """M_E on (16, 12, N) limbs: the three M4 blocks at once, then the
    column sums (a field sum has the same bits in any order)."""
    add = ctx.add
    x = s.reshape((L, 3, 4) + s.shape[2:])
    x0, x1, x2, x3 = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    t0 = add(x0, x1)
    t1 = add(x2, x3)
    t2 = add(add(x1, x1), t1)
    t3 = add(add(x3, x3), t0)
    t1_2 = add(t1, t1)
    t0_2 = add(t0, t0)
    t4 = add(add(t1_2, t1_2), t3)
    t5 = add(add(t0_2, t0_2), t2)
    blk = torch.stack([add(t3, t5), t5, add(t2, t4), t4], dim=2)  # (16, 3, 4, N)
    sums = add(add(blk[:, 0], blk[:, 1]), blk[:, 2])  # (16, 4, N)
    return add(blk, sums[:, None]).reshape(s.shape)


def _internal_plain(ctx, s, mu):
    tot = s[:, 0]
    for i in range(1, WIDTH):
        tot = ctx.add(tot, s[:, i])
    return ctx.add(tot[:, None], ctx.mont_mul_plain(mu, s))


def _perm_mont_plain(s: torch.Tensor) -> torch.Tensor:
    """(16, 12, N) Montgomery limbs -> permuted: the JAX package's
    `_perm_device_run` (full rounds, partial rounds on lane 0, full rounds)
    over `mont_mul_plain`, with no kernel launch."""
    ctx = _ctx()
    rc_full, rc_part, mu, _, _ = _device_consts(s.device)
    half = FULL_ROUNDS // 2

    def full(s, rc):
        s = ctx.add(s, rc)
        return _external_plain(ctx, _sbox_plain(ctx, s))

    s = _external_plain(ctx, s)
    for r in range(half):
        s = full(s, rc_full[:, r])
    for r in range(PARTIAL_ROUNDS):
        l0 = _sbox_plain(ctx, ctx.add(s[:, 0], rc_part[:, r]))
        s = _internal_plain(ctx, torch.cat([l0[:, None], s[:, 1:]], dim=1), mu)
    for r in range(half, FULL_ROUNDS):
        s = full(s, rc_full[:, r])
    return s


def perm_fr_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel F's `perm` entry: (..., 12, 4) words ->
    permuted, the same shape."""
    lead = state.shape[:-2]
    s = _to_mont(words_to_limbs(state.reshape(-1, WIDTH, WORDS).movedim(0, 1)))  # (16, 12, N)
    out = _from_mont(_perm_mont_plain(s))
    return limbs_to_words(out).movedim(0, 1).reshape(lead + (WIDTH, WORDS))


def _cap_limbs(value: int, n: int, device) -> torch.Tensor:
    return _ctx().const_mont(value, (n,), device)


def hash_rows_fr_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel F's `hash_rows` entry: (n, k) canonical
    Goldilocks rows (int64) -> (n, 4) words of `hash_elements_host(
    pack_gl_host(row), "leaf")`, the JAX package's `_leaf_digests_device`."""
    n, k = rows.shape
    n_fr = -(-k // GL_PACK)
    packed = _to_mont(words_to_limbs(pack_gl_device(rows)))  # (16, n, n_fr)
    s = torch.zeros((L, WIDTH, n), dtype=torch.int32, device=rows.device)
    s[:, WIDTH - 1] = _cap_limbs(sponge_capacity("leaf", n_fr), n, rows.device)
    ctx = _ctx()
    for b in range(0, n_fr, RATE):
        blk = packed[:, :, b : b + RATE].movedim(2, 1)  # (16, <=RATE, n)
        w = blk.shape[1]
        s = torch.cat([ctx.add(s[:, :w], blk), s[:, w:]], dim=1)
        s = _perm_mont_plain(s)
    return limbs_to_words(_from_mont(s[:, 0]))


def _compress_plain(pairs: torch.Tensor) -> torch.Tensor:
    """(16, 2, m) Montgomery digests (left, right) -> (16, m): one
    permutation each under the node tag."""
    m = pairs.shape[-1]
    s = torch.zeros((L, WIDTH, m), dtype=torch.int32, device=pairs.device)
    s[:, :2] = pairs
    s[:, WIDTH - 1] = _cap_limbs(_sha_to_fr("ezt-pfr-sponge/node"), m, pairs.device)
    return _perm_mont_plain(s)[:, 0]


def merkle_levels_fr_plain(digests: torch.Tensor) -> list[torch.Tensor]:
    """Plain version of kernel F's `merkle_levels` entry: (n, 4) leaf
    digests (n a power of two) -> every level above, [(n/2, 4), ...,
    (1, 4)], one node-tag compression a pair (`hash_two_host`)."""
    cur = _to_mont(words_to_limbs(digests))  # (16, n)
    out = []
    while cur.shape[-1] > 1:
        cur = _compress_plain(torch.stack([cur[:, 0::2], cur[:, 1::2]], dim=1))
        out.append(limbs_to_words(_from_mont(cur)))
    return out


# ---------------------------------------------------------------------------
# the device form


def perm_device(state: torch.Tensor) -> torch.Tensor:
    """(..., 12, 4) words -> permuted: kernel F on a CUDA tensor, the plain
    version on the CPU."""
    from . import kernels

    if state.is_cuda:
        return kernels.poseidon_fr_perm(state)
    return perm_fr_plain(state)


def pack_gl_device(values: torch.Tensor) -> torch.Tensor:
    """(..., k) canonical Goldilocks values (int64) -> (..., ceil(k/3), 4)
    words: value j of a group in word j, word 3 zero (the JAX package's
    limbs 12-15)."""
    k = values.shape[-1]
    n_fr = -(-k // GL_PACK)
    pad = n_fr * GL_PACK - k
    if pad:
        values = torch.cat([values, values.new_zeros(values.shape[:-1] + (pad,))], dim=-1)
    grouped = values.reshape(values.shape[:-1] + (n_fr, GL_PACK))
    return torch.cat([grouped, grouped.new_zeros(grouped.shape[:-1] + (1,))], dim=-1)
