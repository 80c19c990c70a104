"""The sliding-window schedule of the port's power kernel (`mont_pow`,
csrc/mont_mul.cu), on the CPU.

`kernels.pow_schedule` is made on the host and handed to the kernel in its
parameter bank; the kernel follows it without reading the exponent.  Here:
the schedule rebuilds the exponent it encodes (edge exponents and 200
random 256-bit ones, windows of 4 and 5 bits); a python model of the
kernel's loop over `PowSchedule`'s fields (the table of odd powers, the
squarings, the entries) computes python's pow; the chain for q - 2 is the
one PERF.md states (55 products and 253 squarings at the chosen width 4, 53
and 253 at width 5, against the binary ladder's 109 and 253); the layout
constants that `PowSchedule` shares with the CUDA source are equal on both
sides.  Tolerance: none, exact integers.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from eigen_zeth_tpu_torch.ops import bn254, kernels

W = kernels.POW_WINDOW
EDGES = (0, 1, 2, 3, (1 << W) - 1, 1 << W, (1 << W) + 1, (1 << 255) + 1,
         bn254.Q - 2, bn254.Q - 1, bn254.R - 2, (1 << 256) - 1, 1 << 255,
         int("1" + "0001" * 63, 2), int("10000" * 51, 2))


def _random_exponents(n=200, seed=11):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(0, 8))
            for _ in range(n)]


def _rebuild(steps):
    e = 0
    for squarings, digit in steps:
        e = (e << squarings) + digit
    return e


def _run_struct(s, x, q):
    """The kernel's loop, in python ints, over the struct it is handed."""
    if s.steps == 0:
        return 1
    table = [x]
    if s.table > 1:
        x2 = x * x % q
        for _ in range(1, s.table):
            table.append(table[-1] * x2 % q)
    r = table[s.entry[0]]
    for k in range(1, s.steps):
        for _ in range(s.squarings[k]):
            r = r * r % q
        if s.entry[k] != kernels.NO_PRODUCT:
            r = r * table[s.entry[k]] % q
    return r


@pytest.mark.parametrize("width", [4, 5])
def test_schedule_rebuilds_its_exponent(width):
    for e in EDGES + tuple(_random_exponents()):
        steps = kernels.pow_schedule(e, width)
        assert _rebuild(steps) == e, hex(e)
        assert len(steps) <= kernels.POW_MAX_STEPS
        if steps:
            assert steps[0][0] == 0 and steps[0][1] % 2 == 1
        for squarings, digit in steps[1:]:
            assert 1 <= squarings <= 255
            assert digit == 0 or (digit % 2 == 1 and digit < 1 << width)
        assert all(d for _, d in steps[:-1])  # only the last may multiply by nothing
        assert kernels.pow_table(steps) <= 1 << (width - 1)


@pytest.mark.parametrize("width", [4, 5])
def test_the_kernels_loop_over_the_struct_is_pow(width):
    rng = np.random.default_rng(12)
    q = bn254.Q
    for e in EDGES + tuple(_random_exponents(40, seed=13)):
        s = kernels.pow_schedule_struct(e, width)
        x = int.from_bytes(rng.bytes(32), "little") % q
        assert _run_struct(s, x, q) == pow(x, e, q), hex(e)


def test_chain_of_the_paths_exponent():
    """q - 2 (Fermat inversion): the counts PERF.md states and chip_smoke.py's
    bound counts."""
    assert W == 4
    assert kernels.pow_chain(kernels.pow_schedule(bn254.Q - 2)) == (55, 253)
    assert kernels.pow_chain(kernels.pow_schedule(bn254.Q - 2, 5)) == (53, 253)
    assert kernels.pow_chain(kernels.pow_schedule(2)) == (0, 1)
    assert kernels.pow_chain(kernels.pow_schedule(3)) == (1, 1)
    assert kernels.pow_chain(kernels.pow_schedule(0)) == (0, 0)


def test_schedule_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        kernels.pow_schedule(1 << 256)
    with pytest.raises(ValueError):
        kernels.pow_schedule(-1)
    with pytest.raises(ValueError):
        kernels.pow_schedule_struct(bn254.Q - 2, 3)
    assert kernels.ctypes.sizeof(kernels.PowSchedule) == 8 + 2 * kernels.POW_MAX_STEPS


def test_layout_constants_match_the_cuda_source():
    """kPowMaxSteps, kNoProduct and kPowMaxTable in csrc/mont_mul.cu are the
    struct's POW_MAX_STEPS, NO_PRODUCT and the table of the widest window."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "mont_mul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (0x[0-9A-Fa-f]+|\d+);", src).group(1), 0)

    assert const("kPowMaxSteps") == kernels.POW_MAX_STEPS
    assert const("kNoProduct") == kernels.NO_PRODUCT
    widest = max(kernels.pow_table(kernels.pow_schedule((1 << 256) - 1, w)) for w in (4, 5))
    assert const("kPowMaxTable") == widest == 16
