"""The port's EVM against the JAX package's, on the same programs.

Each scenario builds a world state and block context in one package, runs
its transactions and calls, and returns everything they produce: every
receipt (status, gas used, logs, the call trace with its return data and
gas), what a call returned or raised, each account's nonce, balance, code
and storage, and the state root.  The scenario runs through both packages
and the records must be equal.  The programs are those of the JAX
package's test_evm.py, test_evm_gas.py, test_evm_cancun.py,
test_evm_4844_6780.py and test_evm_precompiles.py (the counter, reverts,
transient storage, MCOPY, SELFDESTRUCT, BLOCKHASH, blob transactions, the
precompiles 0x01-0x09 with BN254 add, mul and pairing on valid, off-curve
and out-of-subgroup input) and random bytecode drawn from a numpy seed.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

from eigen_zeth_tpu.sequencer import evm as j_evm
from eigen_zeth_tpu_torch.ops import bn254, keccak
from eigen_zeth_tpu_torch.sequencer import evm as p_evm

SENDER = "0x" + "11" * 20
OTHER = "0x" + "22" * 20
TARGET = "0x" + "c0" * 20
Q = bn254.Q


def norm(x):
    """A package-neutral form of a result: dataclasses by class name and
    fields, containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, norm(vars(x)))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def outcome(fn, *args):
    try:
        return ("ok", norm(fn(*args)))
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("raised", type(e).__name__, str(e))


def state_record(state):
    return {
        "accounts": {a: (acc.nonce, acc.balance, acc.code.hex(), sorted(acc.storage.items()))
                     for a, acc in sorted(state.accounts.items())},
        "root": state.state_root().hex(),
    }


def block_hash_fn(n: int) -> int:
    return int.from_bytes(keccak.keccak256_host(b"block" + n.to_bytes(8, "big")), "big")


def new_evm(m, **ctx):
    ctx = dict(dict(number=300, timestamp=1000, prevrandao=77, basefee=0, blob_basefee=3,
                    coinbase="0x" + "cb" * 20, block_hash_fn=block_hash_fn), **ctx)
    state = m.WorldState()
    return m.EVM(state, m.BlockCtx(**ctx)), state


def init_code(runtime: bytes) -> bytes:
    """Init code that returns `runtime` (CODECOPY + RETURN)."""
    return bytes([0x60, len(runtime), 0x60, 0x0C, 0x60, 0x00, 0x39,
                  0x60, len(runtime), 0x60, 0x00, 0xF3]) + runtime


def same(scenario, *args):
    got = scenario(p_evm, *args)
    want = scenario(j_evm, *args)
    assert got == want
    return got


# --- the JAX package's programs ---------------------------------------------

COUNTER = bytes([0x60, 0x00, 0x54, 0x60, 0x01, 0x01, 0x60, 0x00, 0x55,
                 0x60, 0x00, 0x54, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3])
REVERTER = bytes([0x60, 0x00, 0x60, 0x00, 0xFD])
# LOG2 of 32 bytes of memory with two topics, then SSTORE(1, CALLVALUE)
LOGGER = bytes([0x60, 0xAB, 0x60, 0x00, 0x52, 0x60, 0x07, 0x60, 0x05, 0x60, 0x20, 0x60, 0x00,
                0xA2, 0x34, 0x60, 0x01, 0x55, 0x00])
# TSTORE(1, 42); TLOAD(1) -> SSTORE(0); MCOPY within memory; return 64 bytes
TRANSIENT = bytes([0x60, 0x2A, 0x60, 0x01, 0x5D, 0x60, 0x01, 0x5C, 0x60, 0x00, 0x55,
                   0x7F]) + bytes(range(1, 33)) + bytes([0x60, 0x00, 0x52,
                   0x60, 0x20, 0x60, 0x00, 0x60, 0x20, 0x5E, 0x60, 0x40, 0x60, 0x00, 0xF3])
# BLOCKHASH of number-1, number-256, number-257 and number; BLOBHASH(0), BLOBBASEFEE
BLOCK_CTX = bytes([0x60, 0x01, 0x43, 0x03, 0x40, 0x60, 0x00, 0x55,
                   0x61, 0x01, 0x00, 0x43, 0x03, 0x40, 0x60, 0x01, 0x55,
                   0x61, 0x01, 0x01, 0x43, 0x03, 0x40, 0x60, 0x02, 0x55,
                   0x43, 0x40, 0x60, 0x03, 0x55,
                   0x60, 0x00, 0x49, 0x60, 0x04, 0x55, 0x4A, 0x60, 0x05, 0x55,
                   0x41, 0x60, 0x06, 0x55, 0x44, 0x60, 0x07, 0x55, 0x46, 0x60, 0x08, 0x55,
                   0x48, 0x60, 0x09, 0x55, 0x00])
SELFDESTRUCT = bytes([0x73]) + bytes.fromhex(OTHER[2:]) + bytes([0xFF])


def scenario_counter_and_reverts(m):
    evm, state = new_evm(m)
    out = []
    r = evm.execute_tx({"to": None, "input": "0x" + init_code(COUNTER).hex(),
                        "gas": hex(5_000_000)}, SENDER)
    out.append(r)
    addr = r["contractAddress"]
    for _ in range(3):
        out.append(evm.execute_tx({"to": addr, "gas": hex(5_000_000)}, SENDER))
    out.append(evm.execute_tx({"to": OTHER, "value": hex(1234)}, SENDER))
    r = evm.execute_tx({"to": None, "input": "0x" + init_code(REVERTER).hex(),
                        "gas": hex(5_000_000)}, SENDER)
    out.append(r)
    out.append(evm.execute_tx({"to": r["contractAddress"], "value": hex(777),
                               "gas": hex(100_000)}, SENDER))
    out.append(evm.execute_tx({"to": addr, "gas": hex(21_100)}, SENDER))  # out of gas
    out.append(evm.execute_tx({"to": addr, "nonce": hex(99)}, SENDER))  # nonce in the future
    out.append(evm.execute_tx({"to": addr, "nonce": hex(0)}, SENDER))  # a stale nonce
    out.append(outcome(evm.call_view, {"to": addr, "from": SENDER}))
    out.append(outcome(evm.estimate_gas, {"to": addr, "from": SENDER}))
    return norm(out) + [state_record(state)]


def scenario_logs_transient_context(m, blob_hashes):
    evm, state = new_evm(m)
    out = []
    for code in (LOGGER, TRANSIENT, BLOCK_CTX):
        r = evm.execute_tx({"to": None, "input": "0x" + init_code(code).hex(),
                            "gas": hex(5_000_000)}, SENDER)
        out.append(r)
        tx = {"to": r["contractAddress"], "gas": hex(500_000), "value": hex(5)}
        if blob_hashes:
            tx.update(blobVersionedHashes=blob_hashes, maxFeePerGas=hex(10),
                      maxPriorityFeePerGas=hex(1), maxFeePerBlobGas=hex(9), type="0x3")
        out.append(evm.execute_tx(tx, SENDER))
    return norm(out) + [state_record(state)]


def scenario_selfdestruct(m):
    evm, state = new_evm(m)
    out = []
    # an old contract: SELFDESTRUCT sweeps its balance, the account stays (EIP-6780)
    r = evm.execute_tx({"to": None, "input": "0x" + init_code(SELFDESTRUCT).hex(),
                        "gas": hex(5_000_000), "value": hex(1000)}, SENDER)
    out.append(r)
    out.append(evm.execute_tx({"to": r["contractAddress"], "gas": hex(100_000)}, SENDER))
    # created and destroyed in one transaction: the account goes
    out.append(evm.execute_tx({"to": None, "input": "0x" + SELFDESTRUCT.hex(),
                               "gas": hex(5_000_000), "value": hex(50)}, SENDER))
    # an EIP-1559 transaction, an access list, a base fee above the cap
    evm.ctx.basefee = 7
    out.append(evm.execute_tx({"to": OTHER, "value": hex(1), "maxFeePerGas": hex(20),
                               "maxPriorityFeePerGas": hex(2), "gas": hex(60_000),
                               "accessList": [{"address": OTHER,
                                               "storageKeys": ["0x" + "00" * 31 + "01"]}]},
                              SENDER))
    out.append(evm.execute_tx({"to": OTHER, "maxFeePerGas": hex(6)}, SENDER))
    out.append(evm.execute_tx({"to": OTHER, "gasPrice": hex(6)}, SENDER))
    return norm(out) + [state_record(state)]


@pytest.mark.parametrize("scenario", [scenario_counter_and_reverts, scenario_selfdestruct],
                         ids=lambda f: f.__name__)
def test_programs_equal(scenario):
    same(scenario)


@pytest.mark.parametrize("blob", [False, True], ids=["plain", "blob-tx"])
def test_logs_transient_storage_block_context_equal(blob):
    hashes = ["0x01" + "ab" * 31, "0x01" + "cd" * 31] if blob else None
    same(scenario_logs_transient_context, hashes)


def test_blob_fee_and_blob_tx_errors_equal():
    for excess in (0, 1, p_evm.TARGET_BLOB_GAS_PER_BLOCK, 10**7, 10**8):
        assert p_evm.blob_base_fee(excess) == j_evm.blob_base_fee(excess)

    def errors(m):
        evm, _ = new_evm(m)
        base = {"to": OTHER, "maxFeePerGas": hex(10), "maxFeePerBlobGas": hex(9), "type": "0x3"}
        return norm([
            evm.execute_tx(dict(base, to=None, blobVersionedHashes=["0x01" + "00" * 31]), SENDER),
            evm.execute_tx(dict(base, blobVersionedHashes=["0x02" + "00" * 31]), SENDER),
            evm.execute_tx(dict(base, maxFeePerBlobGas=hex(1),
                                blobVersionedHashes=["0x01" + "00" * 31]), SENDER),
        ])

    same(errors)


# --- the precompiles --------------------------------------------------------


def g1_bytes(p) -> bytes:
    return bytes(64) if p is None else p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def g2_bytes(p) -> bytes:
    (x0, x1), (y0, y1) = p  # EIP-197: the imaginary word first
    return b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))


def fq2_sqrt(a):
    """A square root in Fq2 = Fq[u]/(u^2 + 1), q = 3 mod 4, or None."""
    a0, a1 = a
    norm_ = (a0 * a0 + a1 * a1) % Q
    alpha = pow(norm_, (Q + 1) // 4, Q)
    if alpha * alpha % Q != norm_:
        return None
    inv2 = pow(2, Q - 2, Q)
    for sign in (1, -1):
        delta = (a0 + sign * alpha) * inv2 % Q
        gamma = pow(delta, (Q + 1) // 4, Q)
        if gamma * gamma % Q == delta and gamma:
            x = (gamma, a1 * pow(2 * gamma, Q - 2, Q) % Q)
            if bn254.h_fq2_mul(x, x) == (a0 % Q, a1 % Q):
                return x
    return None


def twist_point_outside_the_subgroup(seed: int):
    """A point of y^2 = x^3 + b2 over Fq2 whose order is not r."""
    rng = np.random.default_rng(seed)
    while True:
        x = (int.from_bytes(rng.bytes(32), "big") % Q, int.from_bytes(rng.bytes(32), "big") % Q)
        x3 = bn254.h_fq2_mul(bn254.h_fq2_mul(x, x), x)
        y = fq2_sqrt(((x3[0] + bn254.B_G2[0]) % Q, (x3[1] + bn254.B_G2[1]) % Q))
        if y is not None:
            p = (x, y)
            assert bn254.h_on_curve_g2(p)
            neg = (x, ((-y[0]) % Q, (-y[1]) % Q))
            if bn254.h_ec_mul_jac_f(bn254.R - 1, p, bn254.HOST_FQ2) != neg:
                return p


def precompile_inputs():
    g = bn254.G1_GEN
    h = (bn254.G2_GEN_X, bn254.G2_GEN_Y)
    neg_g = (g[0], Q - g[1])
    a = 7
    ag = bn254.h_ec_mul(a, g)
    ah = bn254.h_ec_mul_jac_f(a, h, bn254.HOST_FQ2)
    off_g1 = (1, 1)
    off_g2 = ((1, 2), (3, 4))
    wild = twist_point_outside_the_subgroup(3)
    m = (1 << 256) - (1 << 32) - 977
    digest = hashlib.sha256(b"ecrecover").digest()
    from eigen_zeth_tpu_torch.utils import secp256k1

    yp, r, s = secp256k1.sign(digest, 0xBEEF)
    blake = bytes.fromhex(
        "0000000c48c9bdf267e6096a3ba7ca8485ae67bb2bf894fe72f36e3cf1361d5f3af54fa5"
        "d182e6ad7f520e511f6c3e2b8c68059b6bbd41fbabd9831f79217e1319cde05b"
        "6162630000000000000000000000000000000000000000000000000000000000" + "00" * 96
        + "0300000000000000" + "0000000000000000" + "01")
    return {
        "ecrecover": (1, digest + (27 + yp).to_bytes(32, "big") + r.to_bytes(32, "big")
                      + s.to_bytes(32, "big")),
        "ecrecover-bad-v": (1, digest + (29).to_bytes(32, "big") + r.to_bytes(32, "big")
                            + s.to_bytes(32, "big")),
        "sha256": (2, b"x" * 45),
        "ripemd160": (3, b"abc"),
        "identity": (4, bytes(range(77))),
        "modexp-eip198": (5, (1).to_bytes(32, "big") + (32).to_bytes(32, "big")
                          + (32).to_bytes(32, "big") + b"\x03" + (m - 1).to_bytes(32, "big")
                          + m.to_bytes(32, "big")),
        "modexp-small": (5, (1).to_bytes(32, "big") * 3 + bytes([3, 5, 7])),
        "ecadd": (6, g1_bytes(g) + g1_bytes(g)),
        "ecadd-infinity": (6, g1_bytes(g) + bytes(64)),
        "ecadd-off-curve": (6, g1_bytes(off_g1) + g1_bytes(g)),
        "ecadd-coordinate-past-q": (6, (Q + 1).to_bytes(32, "big") + (2).to_bytes(32, "big")
                                    + g1_bytes(g)),
        "ecmul": (7, g1_bytes(g) + (0x1234_5678_9ABC_DEF0_1111).to_bytes(32, "big")),
        "ecmul-scalar-past-r": (7, g1_bytes(ag) + (bn254.R + 5).to_bytes(32, "big")),
        "ecmul-off-curve": (7, g1_bytes(off_g1) + (2).to_bytes(32, "big")),
        "pairing-one": (8, g1_bytes(g) + g2_bytes(h) + g1_bytes(neg_g) + g2_bytes(h)),
        "pairing-not-one": (8, (g1_bytes(g) + g2_bytes(h)) * 2),
        "pairing-bilinear": (8, g1_bytes(ag) + g2_bytes(h) + g1_bytes(neg_g) + g2_bytes(ah)),
        "pairing-empty": (8, b""),
        "pairing-g1-off-curve": (8, g1_bytes(off_g1) + g2_bytes(h)),
        "pairing-g2-off-curve": (8, g1_bytes(g) + g2_bytes(off_g2)),
        "pairing-g2-outside-subgroup": (8, g1_bytes(g) + g2_bytes(wild)),
        "pairing-bad-length": (8, g1_bytes(g) + g2_bytes(h)[:-1]),
        "blake2f": (9, blake),
        "blake2f-bad-length": (9, blake[:-1]),
        "blake2f-bad-flag": (9, blake[:-1] + b"\x02"),
    }


PRECOMPILE_INPUTS = precompile_inputs()


def scenario_precompile(m, name: str):
    n, data = PRECOMPILE_INPUTS[name]
    addr = "0x" + "00" * 19 + f"{n:02x}"
    evm, state = new_evm(m)
    direct = [outcome(evm._call, SENDER, addr, 0, data, gas, 0)
              for gas in (10_000_000, 72, 71, 3000)]
    # through a transaction, and through STATICCALL from a contract that
    # returns (success, returndata): a failed precompile is push-0 there
    receipt = evm.execute_tx({"to": addr, "input": "0x" + data.hex(), "gas": hex(9_000_000)},
                             SENDER)
    caller = bytes([0x36, 0x60, 0x00, 0x60, 0x00, 0x37,  # CALLDATACOPY(0, 0, size)
                    0x60, 0x00, 0x60, 0x00, 0x36, 0x60, 0x00, 0x60, n, 0x5A, 0xFA,
                    0x60, 0x00, 0x55,  # SSTORE(0, success)
                    0x3D, 0x60, 0x00, 0x60, 0x00, 0x3E,  # RETURNDATACOPY(0, 0, size)
                    0x3D, 0x60, 0x00, 0xF3])
    r = evm.execute_tx({"to": None, "input": "0x" + init_code(caller).hex(),
                        "gas": hex(5_000_000)}, SENDER)
    call = evm.execute_tx({"to": r["contractAddress"], "input": "0x" + data.hex(),
                           "gas": hex(9_000_000)}, SENDER)
    return [direct, norm(receipt), norm(call), state_record(state)]


@pytest.mark.parametrize("name", sorted(PRECOMPILE_INPUTS))
def test_precompile_equal(name):
    got = same(scenario_precompile, name)
    if name in ("pairing-one", "pairing-bilinear", "pairing-empty"):
        assert got[0][0] == ("ok", [(1).to_bytes(32, "big"), got[0][0][1][1]])
    if name.endswith(("off-curve", "outside-subgroup", "bad-length", "past-q")):
        assert got[0][0][0] == "raised"  # the call fails


# --- random bytecode ----------------------------------------------------------

# every opcode the interpreter knows, but the halting INVALID slots
OPS = ([*range(0x01, 0x0C), *range(0x10, 0x1E), 0x20, *range(0x30, 0x4B), *range(0x50, 0x60),
        *range(0x80, 0xA5), 0xF0, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xFA, 0xFD, 0xFF, 0x00])


def random_program(rng, n_ops: int) -> bytes:
    """Ops with small operands pushed before each, so most of them run."""
    out = bytearray()
    for _ in range(n_ops):
        for _ in range(7):  # as many operands as CALL takes
            if rng.random() < 0.93:
                out += bytes([0x60, int(rng.choice([0, 1, 2, 3, 9, 31, 32, 64, 0xFF]))])
            elif rng.random() < 0.6:  # an address: a precompile, the target or the sender
                out += bytes([0x73]) + bytes.fromhex(
                    rng.choice(["00" * 19 + f"{int(rng.integers(1, 10)):02x}", TARGET[2:],
                                SENDER[2:]]))
            else:
                out += bytes([0x7F]) + rng.bytes(32)
        op = int(rng.choice(OPS))
        if op == 0x56 or op == 0x57:  # jumps land on JUMPDEST now and then
            out += (bytes([0x61]) + (len(out) + 4).to_bytes(2, "big") + bytes([op, 0x5B])
                    if rng.random() < 0.5 else bytes([op]))
        else:
            out.append(op)
    return bytes(out)


def scenario_random(m, seed: int):
    rng = np.random.default_rng(seed)
    evm, state = new_evm(m)
    records = []
    for i in range(24):
        code = random_program(rng, int(rng.integers(2, 16)))
        data = "0x" + rng.bytes(int(rng.integers(0, 70))).hex()
        if i % 4 == 3:  # as init code
            tx = {"to": None, "input": "0x" + code.hex()}
        else:
            state.touch(TARGET).code = code
            tx = {"to": TARGET, "input": data}
        tx.update(gas=hex(int(rng.choice([30_000, 100_000, 1_000_000]))),
                  value=hex(int(rng.integers(0, 3))))
        records.append(evm.execute_tx(tx, SENDER))
        records.append(outcome(evm.call_view, dict(tx, **{"from": SENDER})))
    return norm(records) + [state_record(state)]


@pytest.mark.parametrize("seed", range(4))
def test_random_bytecode_equal(seed):
    same(scenario_random, seed)
