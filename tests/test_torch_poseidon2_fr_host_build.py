"""Kernel F's own arithmetic on the CPU: csrc/poseidon2_fr.cuh built with the
host C++ compiler.

The header compiles without nvcc; the PTX carry-flag operations are then
emulated, and the emulation refuses a chain that hands an addition's carry
to a subtraction or the reverse (such chains computed wrong words on the
H100).  A small harness runs the core the kernel runs, on the constants as
ops/kernels.py lays them out:

  * whole permutations of regular states (into Montgomery form and out, as
    `perm` does) and of lazy Montgomery states (any words below 2^256, the
    permutation's entry range), against the JAX package's `perm_host`;
  * the leaf sponge (k = 1, 3, 33, 216 Goldilocks values, p - 1 among them)
    against `hash_elements_host(pack_gl_host(row))`, and the node
    compression against `hash_two_host`;
  * the way out of Montgomery form, on every representative of 0 below
    2^256 among others (it must leave canonical);
  * each step at the top of the range the header states for its inputs
    (the product, the square, Shoup's product by a diagonal constant,
    `reduce`, M_E, a full and a partial round):
    the output must be congruent to the reference and inside its stated
    range.

Edge lanes: 0, 1, r - 1, r - 2, 2^64 - 1, 2^192 - 1, and seeded random
states.  Tolerance: none, exact integer equality (congruence plus the range
for the lazy steps).  `test_lazy_ranges_hold` is the python model of the
header's ranges: it asserts every bound the header states.  Skips only
where no C++ compiler is installed.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from eigen_zeth_tpu.ops import poseidon_fr as jpfr
from eigen_zeth_tpu_torch.ops import kernels
from eigen_zeth_tpu_torch.ops import poseidon_fr as pfr

R = pfr.R
MONT = 1 << 256
RINV = pow(MONT, -1, R)
R_PLUS = R + (1 << 232)  # `reduce`'s bound
GL_P = (1 << 64) - (1 << 32) + 1
EDGE = [0, 1, R - 1, R - 2, (1 << 64) - 1, (1 << 192) - 1]

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <string>
#include "poseidon2_fr.cuh"
namespace fr = ezt::fr;
using fr::Fe;
using fr::Wide;
// values travel as hex strings, most significant digit first
static bool read_words(unsigned* w, int n) {
  char buf[200];
  if (scanf("%199s", buf) != 1) return false;
  std::memset(w, 0, n * sizeof(unsigned));
  const int len = std::strlen(buf);
  for (int i = 0; i < len; ++i) {
    const char ch = buf[len - 1 - i];
    const unsigned d = ch <= '9' ? ch - '0' : (ch | 32) - 'a' + 10;
    if (i / 8 >= n) return d == 0;
    w[i / 8] |= d << (4 * (i % 8));
  }
  return true;
}
static bool read_fe(Fe& x) { return read_words(x.w, fr::kWords); }
static void put(const Fe& x) {
  for (int k = fr::kWords - 1; k >= 0; --k) printf("%08x", x.w[k]);
  printf(" ");
}
static bool read_state(Fe (&s)[12]) {
  for (auto& x : s) if (!read_fe(x)) return false;
  return true;
}
static void put_state(const Fe (&s)[12]) {
  for (const auto& x : s) put(x);
  printf("\n");
}
// stdin: the 1,416 constant words, then commands; one output line each
int main() {
  fr::Consts c;
  unsigned* cw = reinterpret_cast<unsigned*>(&c);
  for (size_t i = 0; i < sizeof(c) / 4; ++i) if (scanf("%u", &cw[i]) != 1) return 1;
  char cmd[16];
  try {
    while (scanf("%15s", cmd) == 1) {
      const std::string op = cmd;
      Fe s[12], a, b;
      if (op == "perm") {  // regular in, regular out
        if (!read_state(s)) return 1;
        for (auto& x : s) x = fr::to_mont(x, c);
        fr::permute(s, c);
        for (auto& x : s) x = fr::from_mont(x);
        put_state(s);
      } else if (op == "lazy") {  // Montgomery words in, regular out
        if (!read_state(s)) return 1;
        fr::permute(s, c);
        for (auto& x : s) x = fr::from_mont(x);
        put_state(s);
      } else if (op == "sponge") {  // cap (Montgomery), k, k Goldilocks words
        long k;
        Fe cap;
        if (!read_fe(cap) || scanf("%ld", &k) != 1) return 1;
        unsigned long long vals[256] = {0};
        for (long j = 0; j < k; ++j) if (scanf("%llu", &vals[j]) != 1) return 1;
        for (int j = 0; j < 11; ++j) s[j] = fr::zero();
        s[11] = cap;
        const long packed = (k + 2) / 3;
        for (long blk = 0; blk < packed; blk += 11) {
          for (int j = 0; j < 11 && blk + j < packed; ++j) {
            const long e = blk + j;
            s[j] = fr::add(s[j], fr::to_mont(fr::pack3(vals[3 * e], vals[3 * e + 1],
                                                       vals[3 * e + 2]), c));
          }
          fr::permute(s, c);
        }
        put(fr::from_mont(s[0]));
        printf("\n");
      } else if (op == "node") {  // cap (Montgomery), left, right
        Fe cap;
        if (!read_fe(cap) || !read_fe(a) || !read_fe(b)) return 1;
        for (int j = 2; j < 11; ++j) s[j] = fr::zero();
        s[0] = fr::to_mont(a, c);
        s[1] = fr::to_mont(b, c);
        s[11] = cap;
        fr::permute(s, c);
        put(fr::from_mont(s[0]));
        printf("\n");
      } else if (op == "regular") {  // a Montgomery word out of the kernel
        if (!read_fe(a)) return 1;
        put(fr::from_mont(a));
        printf("\n");
      } else if (op == "mul") {
        if (!read_fe(a) || !read_fe(b)) return 1;
        put(fr::mont_mul(a, b));
        printf("\n");
      } else if (op == "sqr") {
        if (!read_fe(a)) return 1;
        put(fr::mont_sqr(a));
        printf("\n");
      } else if (op == "mulc") {  // lane index i, x, t: t + x·mu_i
        int i;
        Fe t;
        if (scanf("%d", &i) != 1 || !read_fe(a) || !read_fe(t)) return 1;
        put(fr::mul_const_add(a, [&](int j) { return c.mu_plain[i].w[j]; },
                              [&](int j) { return c.mu_quot[i].w[j]; }, t));
        printf("\n");
      } else if (op == "reduce") {
        Wide v;
        if (!read_words(v.w, fr::kWords + 1)) return 1;
        put(fr::reduce(v));
        printf("\n");
      } else if (op == "external") {
        if (!read_state(s)) return 1;
        fr::external(s);
        put_state(s);
      } else if (op == "full") {  // round index, state
        int r;
        if (scanf("%d", &r) != 1 || !read_state(s)) return 1;
        fr::full_round(s, c.rc_full[r]);
        put_state(s);
      } else if (op == "partial") {
        int r;
        if (scanf("%d", &r) != 1 || !read_state(s)) return 1;
        fr::partial_round(s, c.rc_part[r], c);
        put_state(s);
      } else {
        return 1;
      }
    }
  } catch (const char* what) {
    fprintf(stderr, "%s\n", what);
    return 2;
  }
  return 0;
}
"""


def _mont_ceil(a: int, b: int) -> int:
    """An exclusive upper bound of a Montgomery product of operands below a and
    below b: a·b/R + r, rounded up."""
    return -(-a * b // MONT) + R


def lazy_bounds() -> dict:
    """The ranges of poseidon2_fr.cuh, each an exclusive upper bound, with
    every precondition the header relies on asserted: a row operand or a
    squared value at most 2^256 - r, a nine-word sum below 2^262."""

    steps = []  # every S-box value's bound

    def sbox(x):
        assert x + R <= MONT  # x^2's operand
        x2 = _mont_ceil(x, x)
        assert x2 + R <= MONT
        x4 = _mont_ceil(x2, x2)
        assert x4 + R <= MONT  # x^5's row operand
        x5 = _mont_ceil(x4, x)
        steps.extend((x2, x4, x5))
        return x5

    lanes = [R_PLUS] * 12  # entering the partial rounds
    for _ in range(pfr.PARTIAL_ROUNDS):
        s0 = sbox(lanes[0] + R)
        tot = s0 + sum(lanes[1:])
        assert tot < 1 << 262
        # lane 0: T + mont_mul(mu_0, s0); lanes 1..11: T + Shoup's product
        lanes = [R_PLUS + _mont_ceil(R, s0)] + [R_PLUS + 3 * R] * 11
        assert lanes[1] < MONT
    full_in = max(R_PLUS, lanes[0])  # lanes 1..11 reduced once after the partial rounds
    full_out = sbox(full_in + R)
    assert 64 * full_out < 1 << 262 and 64 * MONT <= 1 << 262
    return {"lane0": lanes[0], "lanes": max(lanes[1:]), "full_in": full_in,
            "sbox": max(steps), "sbox_out": full_out, "tot": tot}


def test_lazy_ranges_hold():
    b = lazy_bounds()
    # the figures the header states
    assert b["lanes"] <= 4 * R + (1 << 232) and b["lane0"] < 2.62 * R
    assert b["full_in"] + R < 3.62 * R and b["sbox"] < 3.47 * R and b["sbox_out"] < 3.24 * R
    assert b["tot"] < 48 * R
    assert 64 * b["sbox_out"] < 1 << 262
    # reduce: q <= v / r, and v - q·r below r + 2^231.4 for every v below 2^262
    quot = (1 << 285) // R
    for v in [(1 << 262) - 1, 64 * b["sbox_out"], b["tot"], R, 2 * R - 1, 1 << 230, (1 << 230) - 1]:
        q = (((v >> 230) * quot) >> 32) >> 23
        assert 0 <= v - q * R < R + (1 << 232) and v - q * R < 1 << 256


def _compile(tmp_path) -> Path:
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(HARNESS)
    exe = tmp_path / "harness"
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", str(kernels.CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    return exe


def _hex(v: int) -> str:
    return format(v, "x")


def _state(values) -> str:
    return " ".join(_hex(v) for v in values)


def _regular(word: int) -> int:
    return word * RINV % R


def test_kernel_arithmetic_built_on_the_host_equals_the_reference(tmp_path):
    exe = _compile(tmp_path)
    rng = np.random.default_rng(0xF7)

    def rand_fr(n, top=R):
        return [int.from_bytes(rng.bytes(33), "little") % top for _ in range(n)]

    bounds = lazy_bounds()
    cmds, checks = [], []

    def run(cmd, check):
        cmds.append(cmd)
        checks.append(check)

    # whole permutations: edge lanes, mixes of them, random states
    states = [[e] * 12 for e in EDGE] + [list(rng.choice(np.array(EDGE, dtype=object), 12))
                                         for _ in range(12)]
    states += [rand_fr(12) for _ in range(10)]
    for st in states:
        run(f"perm {_state(st)}", lambda out, st=st: out == jpfr.perm_host(st))
    # lazy Montgomery states at the entry's top: words up to 2^256 - 1
    lazy = [[MONT - 1] * 12, [MONT - 1 - k for k in range(12)], [R + 1] * 12,
            rand_fr(12, MONT), [MONT - R] * 6 + [2 * R - 1] * 6]
    for st in lazy:
        run(f"lazy {_state(st)}",
            lambda out, st=st: out == jpfr.perm_host([_regular(v) for v in st]))
    # the leaf sponge and the node compression
    for k in (1, 3, 33, 216):
        for row in ([GL_P - 1] * k, [0] * k, [int(v) for v in rng.integers(0, GL_P, k, dtype=np.uint64)]):
            cap = pfr.sponge_capacity("leaf", -(-k // pfr.GL_PACK)) * MONT % R
            run(f"sponge {_hex(cap)} {k} " + " ".join(map(str, row)),
                lambda out, row=row: out == [jpfr.hash_elements_host(jpfr.pack_gl_host(row))])
    node_cap = pfr._sha_to_fr("ezt-pfr-sponge/node") * MONT % R
    for left, right in [(0, 0), (R - 1, R - 1), (R - 2, 1), ((1 << 192) - 1, (1 << 64) - 1),
                        *zip(rand_fr(4), rand_fr(4))]:
        run(f"node {_hex(node_cap)} {_hex(left)} {_hex(right)}",
            lambda out, lr=(left, right): out == [jpfr.hash_two_host(*lr)])

    # the way out: every representative of 0 (r, 2r, .., 5r) leaves as 0
    for v in [0, R, 2 * R, 5 * R, R - 1, R + 1, MONT - 1, *rand_fr(3, MONT)]:
        run(f"regular {_hex(v)}", lambda out, v=v: out == [_regular(v)])

    # the steps at the top of their stated input ranges
    def congruent_below(out, want, bound):
        return all(o % R == w % R and o < bound for o, w in zip(out, want))

    row_top = MONT - R  # the largest row operand and squared value
    for a, b in [(row_top, MONT - 1), (R - 1, MONT - 1), (row_top, R - 1), (1, MONT - 1),
                 (row_top - 7, MONT - 2), *zip(rand_fr(4, row_top), rand_fr(4, MONT))]:
        run(f"mul {_hex(a)} {_hex(b)}",
            lambda out, a=a, b=b: congruent_below(out, [a * b * RINV], _mont_ceil(a, b)))
    for a in [row_top, row_top - 1, R - 1, 2 * R, *rand_fr(4, row_top)]:
        run(f"sqr {_hex(a)}", lambda out, a=a: congruent_below(out, [a * a * RINV], _mont_ceil(a, a)))
    mu = jpfr.internal_diag()
    for i, x, tt in [(1, MONT - 1, R_PLUS - 1), (11, MONT - 1, R_PLUS - 1), (5, 0, R_PLUS - 1),
                     (7, R - 1, 0), (2, MONT - R, R), *[(i, v, w) for i, v, w in
                                                       zip(range(1, 12), rand_fr(11, MONT),
                                                           rand_fr(11, R_PLUS))]]:
        run(f"mulc {i} {_hex(x)} {_hex(tt)}",
            lambda out, i=i, x=x, tt=tt: congruent_below(out, [tt + x * mu[i]], tt + 3 * R))
    for v in [(1 << 262) - 1, (1 << 262) - (1 << 200), 64 * bounds["sbox_out"], bounds["tot"],
              R, R - 1, 2 * R, (1 << 230) - 1, 1 << 256, *rand_fr(4, 1 << 262)]:
        run(f"reduce {_hex(v)}", lambda out, v=v: congruent_below(out, [v], R_PLUS))
    for st in [[MONT - 1] * 12, [MONT - 1 - k for k in range(12)], rand_fr(12, MONT)]:
        run(f"external {_state(st)}",
            lambda out, st=st: congruent_below(out, jpfr._external_host([v % R for v in st]),
                                               R_PLUS))
    rc = jpfr.round_constants()
    mont_rc = [[v * MONT % R for v in row] for row in rc]
    full_rounds = [r for r in range(pfr.N_ROUNDS) if pfr._is_full_round(r)]
    part_rounds = [r for r in range(pfr.N_ROUNDS) if not pfr._is_full_round(r)]

    def full_ref(st, r):
        x = [jpfr._sbox_host((_regular(v) + c) % R) for v, c in zip(st, rc[r])]
        return [v * MONT for v in jpfr._external_host(x)]

    def part_ref(st, r):
        x = [_regular(v) for v in st]
        x[0] = jpfr._sbox_host((x[0] + rc[r][0]) % R)
        return [v * MONT for v in jpfr._internal_host(x)]

    full_top = bounds["full_in"] - 1
    for idx, st in [(0, [full_top] * 12), (7, [full_top - k for k in range(12)]),
                    (3, [R_PLUS - 1] * 12), (5, rand_fr(12, full_top))]:
        run(f"full {idx} {_state(st)}",
            lambda out, st=st, r=full_rounds[idx]: congruent_below(out, full_ref(st, r), R_PLUS))
    lane0_top, lanes_top = bounds["lane0"] - 1, bounds["lanes"] - 1
    for idx, st in [(0, [lane0_top] + [lanes_top] * 11), (67, [lane0_top - 3] + [lanes_top - 5] * 11),
                    (30, [R_PLUS - 1] * 12), (11, rand_fr(1, lane0_top) + rand_fr(11, lanes_top))]:
        run(f"partial {idx} {_state(st)}",
            lambda out, st=st, r=part_rounds[idx]: (
                congruent_below(out[:1], part_ref(st, r)[:1], bounds["lane0"])
                and congruent_below(out[1:], part_ref(st, r)[1:], bounds["lanes"])))

    lines = [" ".join(map(str, kernels.poseidon_fr_const_words()))] + cmds
    proc = subprocess.run([str(exe)], input="\n".join(lines) + "\n", capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    outs = proc.stdout.strip().splitlines()
    assert len(outs) == len(cmds)
    for cmd, line, check in zip(cmds, outs, checks):
        out = [int(v, 16) for v in line.split()]
        assert check(out), cmd[:120]
