"""Recursive verification — port of eigen_zeth_tpu/models/recursion.py: a
verifier AIR that re-executes a chunk STARK's query checks inside an
aggregation STARK.

A verifier of the aggregated proof checks the chunk proofs' Merkle
openings, terminal-polynomial evaluations and constraint-composition
equalities cryptographically: corrupting a chunk proof makes the
attestation STARK unprovable and unverifiable without anyone re-running
host chunk verification.

The layout, the schedule, the constraints (written against the algebra
interface of models/air.py) and `build_verifier_trace` are the JAX
package's; the trace is built in numpy on the host and the (rows, columns)
trace goes to the device in one transfer, where `air.prove` extends,
commits, composes and opens it.  The wrap-profile functions
(`attest_chunk_wrap`, `wrap_attestation_instance`,
`verify_attestation_wrap`) prove and check the same AIR under Poseidon2-Fr
commitments (models/air_wrap.py), the form the Groth16 circuit verifies.

Child proofs are chunk STARKs in the recursion-friendly zero-layer-FRI
shape (models/stark.py with terminal_size = the LDE domain size): the
FRI commitment degenerates to the terminal coefficients sent in the
clear, so child verification is exactly
    per query index jj (transcript-derived):
      1. four Merkle openings of the trace tree at
         [jj, jj+blowup, jj+m/2, jj+m/2+blowup] against trace_root;
      2. terminal-poly evaluation at x = shift*w^jj and at -x;
      3. the chunk AIR composition recomputed from the opened
         (A, D) values equals those evaluations.
The verifier AIR executes all three per query.  The cheap O(header)
transcript replay (deriving alphas and the query indices) stays on the
aggregation verifier's host; every derived value is bound into the AIR
as a public input (roots/alphas/iv/out directly; the query indices via a
Poseidon chaining digest recomputed inside the trace; the terminal
coefficients via a Poseidon sponge digest recomputed inside the trace).

Layout: the trace is Qc periods (one per child query) of L rows; L is a
power-of-two count of 32-row slots.  A slot is one Poseidon permutation
(rows 0..29 = rounds, 30..31 hold) or a pad.  Per period:

    [leaf_0][comp_0,0..d-1] ... [leaf_3][comp_3,0..d-1]   Merkle paths
    [idx]                                                  index chain
    [stream_0..n_c/8-1]                                    coeff sponge
                                                           + dual Horner
    [pad...]                                               to pow2 slots

Degree discipline (models/air.py): every additive term of every
constraint is at most {2 trace x 1 periodic} or {1 trace x 2 periodic}
factors, so the composition quotient stays < 2n and FRI proves it on the
8n coset at ratio 4.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon
from . import air as air_m
from . import air_wrap, stark
from .poseidon_tags import chunk_gamma
from .transcript import Transcript

W = poseidon.WIDTH  # 12
RATE = poseidon.RATE  # 8
NR = poseidon.N_ROUNDS  # 30
HALF = poseidon.FULL_ROUNDS // 2  # 4
SLOT = 32


def _is_full_round(r: int) -> bool:
    return r < HALF or r >= HALF + poseidon.PARTIAL_ROUNDS


# ---------------------------------------------------------------------------
# layout: named column indices


def n_fold_layers(n_c: int, terminal: int) -> int:
    """Fold layers of the child FRI: fold while the domain exceeds the
    terminal size (mirrors fri.fri_prove's loop; 0 = zero-layer child)."""
    m_c = 4 * n_c
    r = 0
    while (m_c >> r) > terminal:
        r += 1
    return r


class Layout:
    def __init__(self, n_c: int, terminal: int | None = None):
        if terminal is None:
            terminal = 4 * n_c  # zero-layer child
        self.R = n_fold_layers(n_c, terminal)
        self.k_sq = n_c.bit_length() - 1  # squarings to reach x^n_c
        c = 0

        def take(n):
            nonlocal c
            out = list(range(c, c + n))
            c += n
            return out

        self.state = take(W)
        self.a2 = take(W)
        self.a4 = take(W)
        self.a6 = take(W)
        self.D = take(RATE)
        self.hu, self.hv = take(2)
        self.la = take(4)  # A values of the 4 opened leaves
        self.ld = take(4)  # D values of the 4 opened leaves
        self.sib = take(4)
        self.bit, self.bw, self.cb = take(3)
        self.iacc, self.xacc = take(2)
        self.idx1 = take(1)[0]
        self.chain = take(4)
        self.root = take(4)
        self.iv, self.out = take(2)
        self.alphas = take(3)
        self.cd = take(4)
        self.sq = take(self.k_sq)  # sq[k] = x^(2^(k+1))
        self.zinv, self.i1u, self.iwu, self.i1v, self.iwv = take(5)
        (self.tu, self.tv, self.q1u, self.q1v, self.q2u, self.q3u,
         self.q2v, self.q3v, self.su, self.sv) = take(10)
        if self.R:
            # fold-layer verification registers (children with real FRI
            # layers).  Per fold layer l:
            #   fu/fv   opened leaf pair (u_l, v_l) of the layer tree
            #   fx      x_l = shift^(2^l)·w_{size_l}^{jj_l}; fx[0] == xacc
            #   fy      y_l = x_l^2 (degree helper; y_{R-1} is ALSO the
            #           terminal evaluation point)
            #   ff      fold value: 2·x·f = x·(u+v) + beta·(u−v)
            #   ftb     top direction bit of jj_l (selects u/v downstream
            #           and the sign in x_{l+1} = (−1)^b·x_l²)
            #   fjx     the layer's pair index (pinned from iacc)
            # Persistent publics: froot (4 per layer), fbeta (1 per layer).
            R = self.R
            self.fu = take(R)
            self.fv = take(R)
            self.fx = take(R)
            self.fy = take(R)
            self.ff = take(R)
            self.ftb = take(R)
            self.fjx = take(R)
            self.froot = [take(4) for _ in range(R)]
            self.fbeta = take(R)
        self.n_cols = c


# ---------------------------------------------------------------------------
# schedule: slot list + periodic patterns


class Schedule:
    def __init__(self, n_c: int, terminal: int | None = None):
        if terminal is None:
            terminal = 4 * n_c
        self.n_c = n_c
        self.m_c = 4 * n_c  # child LDE domain (blowup 4)
        self.depth = self.m_c.bit_length() - 1
        self.R = n_fold_layers(n_c, terminal)
        # the coefficient stream: the child's terminal polynomial — all
        # n_c coefficients for a zero-layer child, terminal/blowup after
        # R folds
        self.n_stream = (terminal // 4) if self.R else n_c
        self.n_blocks = max(1, self.n_stream // RATE)
        assert self.n_stream % RATE == 0 or self.n_stream < RATE, (
            "terminal coefficient count must be rate-aligned"
        )
        # per fold layer l: tree over half_l = m_c/2^(l+1) leaves
        self.fdepth = [self.depth - 1 - l for l in range(self.R)]
        slots = []
        for p in range(4):
            slots.append(("leaf", p))
            for k in range(self.depth):
                slots.append(("comp", p, k))
        self.fleaf_slots = []
        for l in range(self.R):
            self.fleaf_slots.append(len(slots))
            slots.append(("fleaf", l))
            for k in range(self.fdepth[l]):
                slots.append(("fcomp", l, k))
        self.idx_slot = len(slots)
        slots.append(("idx",))
        self.stream0_slot = len(slots)
        for b in range(self.n_blocks):
            slots.append(("stream", b))
        n_slots = 1 << (len(slots) - 1).bit_length()
        while len(slots) < n_slots:
            slots.append(("pad",))
        self.slots = slots
        self.L = n_slots * SLOT
        self.last_stream_slot = self.stream0_slot + self.n_blocks - 1
        self.arith_row = self.last_stream_slot * SLOT + min(RATE, self.n_stream)
        self.cdcheck_row = self.last_stream_slot * SLOT + 31
        self.chainx_row = self.idx_slot * SLOT + 31
        # last comp slot of each trace path
        self.pend_rows = [
            (p * (1 + self.depth) + self.depth) * SLOT + 31 for p in range(4)
        ]
        self.leaf_rows = [p * (1 + self.depth) * SLOT for p in range(4)]
        # fold-path landmarks: leaf row, root-equality (pend) row, and the
        # row whose load carries the TOP direction bit (last comp load)
        self.fleaf_rows = [s * SLOT for s in self.fleaf_slots]
        self.fpend_rows = [
            (self.fleaf_slots[l] + self.fdepth[l]) * SLOT + 31
            for l in range(self.R)
        ]
        self.flast_rows = [r - SLOT for r in self.fpend_rows]  # top-bit load

    def is_perm(self, s) -> bool:
        return self.slots[s][0] != "pad"

    def patterns(self) -> Dict[str, np.ndarray]:
        """Periodic selector/constant patterns over one period (length L),
        plus the period-32 round-constant / lane patterns."""
        L = self.L
        z = lambda: np.zeros(L, dtype=np.uint64)
        pat = {
            "g_full": z(), "g_partial": z(), "g_hold": z(), "g_init": z(),
            "load_comp": z(), "load_comp_p1": z(), "load_idx": z(),
            "load_stream0": z(), "load_stream": z(),
            "leafrow0": z(), "leafrow1": z(), "leafrow2": z(), "leafrow3": z(),
            "pend": z(), "pend_p2": z(), "pend_p3": z(), "pend_p4": z(),
            "idx1set": z(), "chainx": z(), "cdcheck": z(), "arith": z(),
            "horner": z(), "dhold": z(),
            "pow2": z(), "wk": z(),
            "h_period": z(), "h_iacc": z(), "h_xacc": z(), "h_hu": z(),
            "h_chain": z(), "h_idx1": z(),
        }
        for l in range(self.R):
            pat[f"fleafrow{l}"] = z()
            pat[f"fpend{l}"] = z()
            pat[f"flast{l}"] = z()
        w_m = gl.primitive_root_of_unity(self.m_c)
        free_into = np.zeros(L, dtype=bool)  # state-free transitions
        for s, slot in enumerate(self.slots):
            base = s * SLOT
            kind = slot[0]
            if kind == "pad":
                pat["g_hold"][base : base + 31] = 1
                nxt = self.slots[(s + 1) % len(self.slots)][0]
                if nxt == "pad":
                    pat["g_hold"][base + 31] = 1
                else:  # wraps into next period's leaf_0: state free
                    free_into[base + 31] = True
                continue
            # Poseidon2 slot: row 0 -> 1 applies the initial external
            # linear layer; rows 1..30 are the 30 rounds; row 31 loads
            pat["g_init"][base] = 1
            for r in range(NR):
                pat["g_full" if _is_full_round(r) else "g_partial"][base + 1 + r] = 1
            # the load transition into the NEXT slot sits at base+31
            nxt = self.slots[(s + 1) % len(self.slots)]
            if nxt[0] in ("leaf", "fleaf"):
                free_into[base + 31] = True  # pinned by leaf value checks
            elif nxt[0] == "comp":
                pat["load_comp"][base + 31] = 1
                _, p, k = nxt
                if p == 0:
                    pat["load_comp_p1"][base + 31] = 1
                    pat["wk"][base + 31] = gl.h_pow(w_m, 1 << k)
                pat["pow2"][base + 31] = (1 << k) % gl.P
            elif nxt[0] == "fcomp":
                # fold-layer Merkle loads share the trace paths' bit-select
                # machinery (load_comp) and index accumulation (pow2)
                pat["load_comp"][base + 31] = 1
                pat["pow2"][base + 31] = (1 << nxt[2]) % gl.P
            elif nxt[0] == "idx":
                pat["load_idx"][base + 31] = 1
            elif nxt[0] == "stream":
                if nxt[1] == 0:
                    pat["load_stream0"][base + 31] = 1
                else:
                    pat["load_stream"][base + 31] = 1
            elif nxt[0] == "pad":
                pat["g_hold"][base + 31] = 1
            if kind == "stream":
                hsteps = min(RATE, self.n_stream)
                pat["horner"][base : base + hsteps] = 1
                pat["dhold"][base : base + max(hsteps - 1, 0)] = 1
        for p, row in enumerate(zip(self.leaf_rows, ["leafrow0", "leafrow1", "leafrow2", "leafrow3"])):
            pat[row[1]][row[0]] = 1
        for p, r in enumerate(self.pend_rows):
            pat["pend"][r] = 1
        pat["pend_p2"][self.pend_rows[1]] = 1
        pat["pend_p3"][self.pend_rows[2]] = 1
        pat["pend_p4"][self.pend_rows[3]] = 1
        pat["idx1set"][self.pend_rows[0]] = 1
        pat["chainx"][self.chainx_row] = 1
        pat["cdcheck"][self.cdcheck_row] = 1
        pat["arith"][self.arith_row] = 1
        for l in range(self.R):
            pat[f"fleafrow{l}"][self.fleaf_rows[l]] = 1
            pat[f"fpend{l}"][self.fpend_rows[l]] = 1
            pat[f"flast{l}"][self.flast_rows[l]] = 1
        # register-hold selectors
        pat["h_period"][: L - 1] = 1
        pat["h_iacc"][:] = 1
        pat["h_iacc"][L - 1] = 0
        leaf_pre = [(r - 1) % L for r in self.leaf_rows + self.fleaf_rows]
        for r in leaf_pre:
            pat["h_iacc"][r] = 0
        pat["h_iacc"][pat["load_comp"] == 1] = 0
        pat["h_xacc"][:] = 1
        pat["h_xacc"][L - 1] = 0
        pat["h_xacc"][pat["load_comp_p1"] == 1] = 0
        pat["h_hu"][:] = 1
        pat["h_hu"][L - 1] = 0
        pat["h_hu"][pat["horner"] == 1] = 0
        pat["h_hu"][pat["load_stream0"] == 1] = 0
        pat["h_chain"][:] = 1
        pat["h_chain"][self.chainx_row] = 0
        pat["h_idx1"][:] = 1
        pat["h_idx1"][L - 1] = 0
        pat["h_idx1"][self.pend_rows[0]] = 0
        # coverage: every transition row is gated by exactly one state term
        cover = (
            pat["g_full"] + pat["g_partial"] + pat["g_hold"] + pat["g_init"]
            + pat["load_comp"]
            + pat["load_idx"] + pat["load_stream0"] + pat["load_stream"]
            + free_into.astype(np.uint64)
        )
        assert np.all(cover == 1), "state transition coverage hole"
        return pat


# period-32 patterns: round constants + Horner lane selectors
def _rc_patterns() -> List[np.ndarray]:
    rc = poseidon.round_constants()
    out = []
    for i in range(W):
        p = np.zeros(SLOT, dtype=np.uint64)
        for r in range(NR):
            p[1 + r] = rc[r][i]  # round r sits at slot row 1+r (row 0 = init)
        out.append(p)
    return out


def _selD_patterns(n_c: int) -> List[np.ndarray]:
    out = []
    for j in range(RATE):
        p = np.zeros(SLOT, dtype=np.uint64)
        if j < min(RATE, n_c):
            p[j] = 1
        out.append(p)
    return out


# ---------------------------------------------------------------------------
# AIR construction


@functools.lru_cache(maxsize=4)
def recursion_air(
    n_c: int,
    shift_c: int = gl.MULTIPLICATIVE_GENERATOR,
    terminal: int | None = None,
):
    """Build the verifier AIR for children of trace size n_c.  Returns
    (air, layout, schedule, per) where per maps periodic-column names to
    indices (rc_i -> 'rc0'.., selD_j -> 'sd0'..).

    terminal = the child FRI's terminal size.  None / >= 4·n_c is the
    zero-layer shape; smaller terminals add R fold layers of in-AIR
    verification — each layer one more Merkle path (the same leaf/comp
    machinery) plus the fold linear-combination and index/x consistency
    checks."""
    lay = Layout(n_c, terminal)
    sch = Schedule(n_c, terminal)
    pat = sch.patterns()
    gamma = chunk_gamma()
    w_last_c = gl.h_pow(gl.primitive_root_of_unity(n_c), n_c - 1)
    me = poseidon.external_matrix()
    mi = poseidon.internal_matrix()

    periodic: List[np.ndarray] = []
    per: Dict[str, int] = {}

    def addp(name, arr):
        per[name] = len(periodic)
        periodic.append(np.asarray(arr, dtype=np.uint64))

    for name, arr in pat.items():
        addp(name, arr)
    for i, arr in enumerate(_rc_patterns()):
        addp(f"rc{i}", arr)
    for j, arr in enumerate(_selD_patterns(sch.n_stream)):
        addp(f"sd{j}", arr)

    C = air_m.Constraint
    cons: List[air_m.Constraint] = []
    me_rows = [[me[i][j] % gl.P for j in range(W)] for i in range(W)]
    mi_rows = [[mi[i][j] % gl.P for j in range(W)] for i in range(W)]

    def S_of(a, cur):
        return a.stack([cur[c] for c in lay.state])

    def RC_of(a, p):
        return a.stack([p[per[f"rc{i}"]] for i in range(W)])

    # --- poseidon sbox aux families: A2 = t^2, A4 = A2^2, A6 = A4*A2 -------
    def aux2(a, cur, nxt, p):
        g = a.add(p[per["g_full"]], p[per["g_partial"]])
        t = a.add(S_of(a, cur), RC_of(a, p))
        A2 = a.stack([cur[c] for c in lay.a2])
        return a.mul(g, a.sub(A2, a.mul(t, t)))

    def aux4(a, cur, nxt, p):
        g = a.add(p[per["g_full"]], p[per["g_partial"]])
        A2 = a.stack([cur[c] for c in lay.a2])
        A4 = a.stack([cur[c] for c in lay.a4])
        return a.mul(g, a.sub(A4, a.mul(A2, A2)))

    def aux6(a, cur, nxt, p):
        g = a.add(p[per["g_full"]], p[per["g_partial"]])
        A2 = a.stack([cur[c] for c in lay.a2])
        A4 = a.stack([cur[c] for c in lay.a4])
        A6 = a.stack([cur[c] for c in lay.a6])
        return a.mul(g, a.sub(A6, a.mul(A4, A2)))

    cons.append(C("pose-a2", aux2, arity=W))
    cons.append(C("pose-a4", aux4, arity=W))
    cons.append(C("pose-a6", aux6, arity=W))

    # --- poseidon state family: rounds + every load path in one family -----
    def state_family(a, cur, nxt, p):
        S = S_of(a, cur)
        NxtS = a.stack([nxt[c] for c in lay.state])
        t = a.add(S, RC_of(a, p))
        A6 = a.stack([cur[c] for c in lay.a6])
        so = a.mul(A6, t)  # sboxed lanes (x^7 via aux)
        ME = a.const_matrix(me_rows)
        MI = a.const_matrix(mi_rows)
        # full round: M_E . sbox(t); initial linear layer: M_E . S
        full_out = a.matvec(ME, so)
        init_out = a.matvec(ME, S)
        # partial round: M_I . (so_0, t_1..t_11)
        #              = M_I.t + M_I[:,0]*(so_0 - t_0)
        mi_t = a.matvec(MI, t)
        col0 = a.const_matrix([mi_rows[i][0] for i in range(W)])  # (W,)
        delta0 = a.sub(a.get0(so, 0), a.get0(t, 0))  # (m,)
        part_out = a.add(mi_t, a.scale_rows(col0, delta0))
        v = a.mul(p[per["g_full"]], a.sub(NxtS, full_out))
        v = a.add(v, a.mul(p[per["g_partial"]], a.sub(NxtS, part_out)))
        v = a.add(v, a.mul(p[per["g_init"]], a.sub(NxtS, init_out)))
        v = a.add(v, a.mul(p[per["g_hold"]], a.sub(NxtS, S)))
        # comp load: lanes 0-3 bit-select (sib, digest); 4-7 mirrored; 8-11 0
        b = cur[lay.bit]
        SIB = a.stack([cur[c] for c in lay.sib])  # (4, m)
        Dg = a.slice0(S, 0, 4)  # previous digest lanes
        left = a.add(a.mul(b, SIB), a.sub(Dg, a.mul(b, Dg)))
        right = a.add(a.mul(b, Dg), a.sub(SIB, a.mul(b, SIB)))
        zero4 = a.zeros(4)
        tgt_comp = a.concat0([left, right, zero4])
        v = a.add(v, a.mul(p[per["load_comp"]], a.sub(NxtS, tgt_comp)))
        # idx-chain load: [chain(4), idx1, 0 x 7]
        CH = a.stack([cur[c] for c in lay.chain])
        tgt_idx = a.concat0(
            [CH, a.stack([cur[lay.idx1]]), a.zeros(W - 5)]
        )
        v = a.add(v, a.mul(p[per["load_idx"]], a.sub(NxtS, tgt_idx)))
        # stream loads: sponge init / absorb (D read at the NEXT row)
        NxtD = a.stack([nxt[c] for c in lay.D])
        tgt_s0 = a.concat0(
            [NxtD, a.stack([a.full(sch.n_stream)]), a.zeros(W - RATE - 1)]
        )
        v = a.add(v, a.mul(p[per["load_stream0"]], a.sub(NxtS, tgt_s0)))
        tgt_sc = a.concat0(
            [a.add(a.slice0(S, 0, RATE), NxtD), a.slice0(S, RATE, W)]
        )
        v = a.add(v, a.mul(p[per["load_stream"]], a.sub(NxtS, tgt_sc)))
        return v

    cons.append(C("pose-state", state_family, arity=W))

    # --- leaf slot input pinning (value checks at leaf row 0) -------------
    def leaf_family(pth):
        def fn(a, cur, nxt, p):
            g = p[per[f"leafrow{pth}"]]
            S = S_of(a, cur)
            want = a.concat0(
                [
                    a.stack([cur[lay.la[pth]], cur[lay.ld[pth]]]),
                    a.zeros(RATE - 2),
                    a.stack([a.full(2)]),
                    a.zeros(W - RATE - 1),
                ]
            )
            return a.mul(g, a.sub(S, want))
        return fn

    for pth in range(4):
        cons.append(C(f"leaf{pth}", leaf_family(pth), domain="all", arity=W))

    # --- direction bits, index/x accumulators ------------------------------
    def bit_bool(a, cur, nxt, p):
        b = cur[lay.bit]
        return a.mul(p[per["load_comp"]], a.sub(a.mul(b, b), b))

    cons.append(C("bit-bool", bit_bool))

    def bw_con(a, cur, nxt, p):
        return a.mul(
            p[per["load_comp_p1"]],
            a.sub(cur[lay.bw], a.mul(cur[lay.bit], p[per["wk"]])),
        )

    cons.append(C("bw", bw_con))

    def iacc_con(a, cur, nxt, p):
        nx = nxt[lay.iacc]
        upd = a.sub(nx, a.add(cur[lay.iacc], a.mul(cur[lay.bit], p[per["pow2"]])))
        v = a.mul(p[per["load_comp"]], upd)
        v = a.add(v, a.mul(p[per["h_iacc"]], a.sub(nx, cur[lay.iacc])))
        return v

    cons.append(C("iacc", iacc_con))

    def iacc_reset(a, cur, nxt, p):
        g = a.add(a.add(p[per["leafrow0"]], p[per["leafrow1"]]),
                  a.add(p[per["leafrow2"]], p[per["leafrow3"]]))
        for l in range(lay.R):
            g = a.add(g, p[per[f"fleafrow{l}"]])
        return a.mul(g, cur[lay.iacc])

    cons.append(C("iacc-reset", iacc_reset, domain="all"))

    def xacc_con(a, cur, nxt, p):
        nx = nxt[lay.xacc]
        # xacc' = xacc * (bw + 1 - bit) on path-0 comp loads
        fac = a.add(cur[lay.bw], a.sub(a.c(1), cur[lay.bit]))
        v = a.mul(p[per["load_comp_p1"]], a.sub(nx, a.mul(cur[lay.xacc], fac)))
        v = a.add(v, a.mul(p[per["h_xacc"]], a.sub(nx, cur[lay.xacc])))
        return v

    cons.append(C("xacc", xacc_con))

    def xacc_init(a, cur, nxt, p):
        return a.mul(p[per["leafrow0"]], a.sub(cur[lay.xacc], a.c(shift_c)))

    cons.append(C("xacc-init", xacc_init, domain="all"))

    def idx1_con(a, cur, nxt, p):
        nx = nxt[lay.idx1]
        v = a.mul(p[per["idx1set"]], a.sub(nx, cur[lay.iacc]))
        v = a.add(v, a.mul(p[per["h_idx1"]], a.sub(nx, cur[lay.idx1])))
        return v

    cons.append(C("idx1", idx1_con))

    # paths 1..3 index relations (vs idx1): +B, +m/2, +m/2+B mod m
    def pend_rel(sel, delta, with_cb):
        def fn(a, cur, nxt, p):
            want = a.add(cur[lay.idx1], a.c(delta))
            if with_cb:
                want = a.sub(want, a.mul(cur[lay.cb], a.c(sch.m_c)))
            return a.mul(p[per[sel]], a.sub(cur[lay.iacc], want))
        return fn

    cons.append(C("pend2", pend_rel("pend_p2", 4, False), domain="all"))
    cons.append(C("pend3", pend_rel("pend_p3", sch.m_c // 2, False), domain="all"))
    cons.append(C("pend4", pend_rel("pend_p4", sch.m_c // 2 + 4, True), domain="all"))

    def cb_bool(a, cur, nxt, p):
        b = cur[lay.cb]
        return a.mul(p[per["pend_p4"]], a.sub(a.mul(b, b), b))

    cons.append(C("cb-bool", cb_bool, domain="all"))

    # --- Merkle root equality at every path end ----------------------------
    def root_eq(a, cur, nxt, p):
        S4 = a.stack([cur[c] for c in lay.state[:4]])
        R = a.stack([cur[c] for c in lay.root])
        return a.mul(p[per["pend"]], a.sub(S4, R))

    cons.append(C("root-eq", root_eq, domain="all", arity=4))

    # --- index chain extraction --------------------------------------------
    def chain_fam(a, cur, nxt, p):
        CH = a.stack([cur[c] for c in lay.chain])
        NxtCH = a.stack([nxt[c] for c in lay.chain])
        S4 = a.stack([cur[c] for c in lay.state[:4]])
        v = a.mul(p[per["chainx"]], a.sub(NxtCH, S4))
        return a.add(v, a.mul(p[per["h_chain"]], a.sub(NxtCH, CH)))

    cons.append(C("chain", chain_fam, arity=4))

    # --- coeff digest check at the sponge's end -----------------------------
    def cd_eq(a, cur, nxt, p):
        S4 = a.stack([cur[c] for c in lay.state[:4]])
        CD = a.stack([cur[c] for c in lay.cd])
        return a.mul(p[per["cdcheck"]], a.sub(S4, CD))

    cons.append(C("cd-eq", cd_eq, domain="all", arity=4))

    # --- dual Horner over the coeff stream ----------------------------------
    def horner(acc_col, neg):
        def fn(a, cur, nxt, p):
            nx = nxt[acc_col]
            selD = a.stack([p[per[f"sd{j}"]] for j in range(RATE)])
            D = a.stack([cur[c] for c in lay.D])
            coeff = a.sum0(a.mul(selD, D))
            if lay.R:
                # terminal evaluation point after R folds: x_term =
                # x_{R-1}^2 = fy[R-1] (no sign flip at the terminal)
                arg = cur[lay.fy[lay.R - 1]]
            else:
                arg = a.sub(a.c(0), cur[lay.xacc]) if neg else cur[lay.xacc]
            step = a.sub(nx, a.add(a.mul(cur[acc_col], arg), coeff))
            v = a.mul(p[per["horner"]], step)
            v = a.add(v, a.mul(p[per["load_stream0"]], nx))
            v = a.add(v, a.mul(p[per["h_hu"]], a.sub(nx, cur[acc_col])))
            return v
        return fn

    cons.append(C("horner-u", horner(lay.hu, False)))
    if not lay.R:
        cons.append(C("horner-v", horner(lay.hv, True)))

    def dhold(a, cur, nxt, p):
        D = a.stack([cur[c] for c in lay.D])
        NxtD = a.stack([nxt[c] for c in lay.D])
        return a.mul(p[per["dhold"]], a.sub(NxtD, D))

    cons.append(C("dhold", dhold, arity=RATE))

    # --- per-period register holds (one family) ------------------------------
    period_regs = (
        lay.la + lay.ld
        + lay.sq + [lay.zinv, lay.i1u, lay.iwu, lay.i1v, lay.iwv,
                    lay.tu, lay.tv, lay.q1u, lay.q1v, lay.q2u, lay.q3u,
                    lay.q2v, lay.q3v, lay.su, lay.sv]
    )
    if lay.R:
        period_regs = period_regs + (
            lay.fu + lay.fv + lay.fx + lay.fy + lay.ff + lay.ftb + lay.fjx
        )

    def period_hold(a, cur, nxt, p):
        R = a.stack([cur[c] for c in period_regs])
        NxtR = a.stack([nxt[c] for c in period_regs])
        return a.mul(p[per["h_period"]], a.sub(NxtR, R))

    cons.append(C("period-hold", period_hold, arity=len(period_regs)))

    # --- trace-persistent registers (publics; one family) --------------------
    persist_regs = lay.root + [lay.iv, lay.out] + lay.alphas + lay.cd
    if lay.R:
        persist_regs = persist_regs + [
            c for quad in lay.froot for c in quad
        ] + lay.fbeta

    def persist(a, cur, nxt, p):
        R = a.stack([cur[c] for c in persist_regs])
        NxtR = a.stack([nxt[c] for c in persist_regs])
        return a.sub(NxtR, R)

    cons.append(C("persist", persist, arity=len(persist_regs)))

    # --- arithmetic value checks (one gated row per period) ------------------
    def ar(fn_inner, name):
        def fn(a, cur, nxt, p):
            return a.mul(p[per["arith"]], fn_inner(a, cur))
        cons.append(C(name, fn, domain="all"))

    # squaring ladder: sq[0] = xacc^2, sq[k] = sq[k-1]^2  -> sq[-1] = x^n_c
    ar(lambda a, cur: a.sub(cur[lay.sq[0]], a.mul(cur[lay.xacc], cur[lay.xacc])),
       "sq-0")
    for k in range(1, lay.k_sq):
        ar(lambda a, cur, k=k: a.sub(
            cur[lay.sq[k]], a.mul(cur[lay.sq[k - 1]], cur[lay.sq[k - 1]])),
           f"sq-{k}")
    xn = lay.sq[-1]
    # inverses: zinv*(x^n-1)=1, i1u*(x-1)=1, iwu*(x-w_last)=1, and at -x
    ar(lambda a, cur: a.sub(
        a.mul(cur[lay.zinv], a.sub(cur[xn], a.c(1))), a.c(1)), "inv-zh")
    ar(lambda a, cur: a.sub(
        a.mul(cur[lay.i1u], a.sub(cur[lay.xacc], a.c(1))), a.c(1)), "inv-1u")
    ar(lambda a, cur: a.sub(
        a.mul(cur[lay.iwu], a.sub(cur[lay.xacc], a.c(w_last_c))), a.c(1)),
       "inv-wu")
    ar(lambda a, cur: a.sub(
        a.mul(cur[lay.i1v], a.sub(a.sub(a.c(0), cur[lay.xacc]), a.c(1))),
        a.c(1)), "inv-1v")
    ar(lambda a, cur: a.sub(
        a.mul(cur[lay.iwv],
              a.sub(a.sub(a.c(0), cur[lay.xacc]), a.c(w_last_c))), a.c(1)),
       "inv-wv")

    # child composition: c1 = A(wx) - gamma*A(x) - D(x); t = c1*(x - w_last)
    def c1_of(a, cur, ia, iwx, idd):
        return a.sub(a.sub(cur[lay.la[iwx]], a.mul(a.c(gamma), cur[lay.la[ia]])),
                     cur[lay.ld[idd]])

    ar(lambda a, cur: a.sub(
        cur[lay.tu],
        a.mul(c1_of(a, cur, 0, 1, 0), a.sub(cur[lay.xacc], a.c(w_last_c)))),
       "t-u")
    ar(lambda a, cur: a.sub(
        cur[lay.tv],
        a.mul(c1_of(a, cur, 2, 3, 2),
              a.sub(a.sub(a.c(0), cur[lay.xacc]), a.c(w_last_c)))), "t-v")
    ar(lambda a, cur: a.sub(cur[lay.q1u], a.mul(cur[lay.tu], cur[lay.zinv])),
       "q1-u")
    ar(lambda a, cur: a.sub(cur[lay.q1v], a.mul(cur[lay.tv], cur[lay.zinv])),
       "q1-v")
    ar(lambda a, cur: a.sub(
        cur[lay.q2u],
        a.mul(a.sub(cur[lay.la[0]], cur[lay.iv]), cur[lay.i1u])), "q2-u")
    ar(lambda a, cur: a.sub(
        cur[lay.q3u],
        a.mul(a.sub(cur[lay.la[0]], cur[lay.out]), cur[lay.iwu])), "q3-u")
    ar(lambda a, cur: a.sub(
        cur[lay.q2v],
        a.mul(a.sub(cur[lay.la[2]], cur[lay.iv]), cur[lay.i1v])), "q2-v")
    ar(lambda a, cur: a.sub(
        cur[lay.q3v],
        a.mul(a.sub(cur[lay.la[2]], cur[lay.out]), cur[lay.iwv])), "q3-v")
    ar(lambda a, cur: a.sub(
        cur[lay.su], a.add(a.mul(cur[lay.alphas[1]], cur[lay.q2u]),
                           a.mul(cur[lay.alphas[2]], cur[lay.q3u]))), "s-u")
    ar(lambda a, cur: a.sub(
        cur[lay.sv], a.add(a.mul(cur[lay.alphas[1]], cur[lay.q2v]),
                           a.mul(cur[lay.alphas[2]], cur[lay.q3v]))), "s-v")
    # final: alpha1*q1 + s == the committed composition value — the
    # terminal Horner evaluation for zero-layer children, the FRI
    # layer-0 opened pair (fu0, fv0) when fold layers are verified
    cu_tgt = (lambda cur: cur[lay.fu[0]]) if lay.R else (lambda cur: cur[lay.hu])
    cv_tgt = (lambda cur: cur[lay.fv[0]]) if lay.R else (lambda cur: cur[lay.hv])
    ar(lambda a, cur: a.sub(
        a.add(a.mul(cur[lay.alphas[0]], cur[lay.q1u]), cur[lay.su]),
        cu_tgt(cur)), "comp-eq-u")
    ar(lambda a, cur: a.sub(
        a.add(a.mul(cur[lay.alphas[0]], cur[lay.q1v]), cur[lay.sv]),
        cv_tgt(cur)), "comp-eq-v")

    # --- fold-layer verification (R >= 1) -------------------------------------
    if lay.R:
        # leaf pinning: layer-l leaf slot hashes the opened pair (u, v)
        def fleaf_family(l):
            def fn(a, cur, nxt, p):
                g = p[per[f"fleafrow{l}"]]
                S = a.stack([cur[c] for c in lay.state])
                want = a.concat0(
                    [
                        a.stack([cur[lay.fu[l]], cur[lay.fv[l]]]),
                        a.zeros(RATE - 2),
                        a.stack([a.full(2)]),
                        a.zeros(W - RATE - 1),
                    ]
                )
                return a.mul(g, a.sub(S, want))
            return fn

        # root equality at the layer path's end
        def froot_eq(l):
            def fn(a, cur, nxt, p):
                S4 = a.stack([cur[c] for c in lay.state[:4]])
                Rt = a.stack([cur[c] for c in lay.froot[l]])
                return a.mul(p[per[f"fpend{l}"]], a.sub(S4, Rt))
            return fn

        # top-bit and pair-index pinning
        def ftb_pin(l):
            def fn(a, cur, nxt, p):
                return a.mul(p[per[f"flast{l}"]],
                             a.sub(cur[lay.ftb[l]], cur[lay.bit]))
            return fn

        def fjx_pin(l):
            def fn(a, cur, nxt, p):
                return a.mul(p[per[f"fpend{l}"]],
                             a.sub(cur[lay.fjx[l]], cur[lay.iacc]))
            return fn

        for l in range(lay.R):
            cons.append(C(f"fleaf{l}", fleaf_family(l), domain="all", arity=W))
            cons.append(C(f"froot{l}", froot_eq(l), domain="all", arity=4))
            cons.append(C(f"ftb{l}", ftb_pin(l), domain="all"))
            cons.append(C(f"fjx{l}", fjx_pin(l), domain="all"))

        # arithmetic checks (all period-constant registers, one gated row):
        #   x ladder        fx0 == xacc;  fy_l == fx_l^2;
        #                   fx_{l+1} == (-1)^{ftb_l}·fy_l  (= fy - 2·tb·fy)
        #   fold relation   2·fx·ff == fx·(fu+fv) + beta·(fu-fv)
        #   layer chaining  ff_l == (1-tb_l)·fu_{l+1} + tb_l·fv_{l+1}
        #   index chaining  fjx_0 == idx1;
        #                   fjx_l == fjx_{l+1} + ftb_l·half_{l+1}
        #   terminal        hu (Horner at fy_{R-1}) == ff_{R-1}
        ar(lambda a, cur: a.sub(cur[lay.fx[0]], cur[lay.xacc]), "fx0-eq")
        ar(lambda a, cur: a.sub(cur[lay.fjx[0]], cur[lay.idx1]), "fjx0-eq")
        for l in range(lay.R):
            ar(lambda a, cur, l=l: a.sub(
                cur[lay.fy[l]], a.mul(cur[lay.fx[l]], cur[lay.fx[l]])),
               f"fy-{l}")
            ar(lambda a, cur, l=l: a.sub(
                a.mul(a.c(2), a.mul(cur[lay.fx[l]], cur[lay.ff[l]])),
                a.add(
                    a.mul(cur[lay.fx[l]],
                          a.add(cur[lay.fu[l]], cur[lay.fv[l]])),
                    a.mul(cur[lay.fbeta[l]],
                          a.sub(cur[lay.fu[l]], cur[lay.fv[l]])),
                )), f"fold-{l}")
        for l in range(lay.R - 1):
            ar(lambda a, cur, l=l: a.sub(
                cur[lay.fx[l + 1]],
                a.sub(cur[lay.fy[l]],
                      a.mul(a.c(2), a.mul(cur[lay.ftb[l]], cur[lay.fy[l]])))),
               f"fxchain-{l}")
            ar(lambda a, cur, l=l: a.sub(
                a.sub(cur[lay.ff[l]], cur[lay.fu[l + 1]]),
                a.mul(cur[lay.ftb[l]],
                      a.sub(cur[lay.fv[l + 1]], cur[lay.fu[l + 1]]))),
               f"fsel-{l}")
            half_next = 1 << (sch.fdepth[l] - 1)
            ar(lambda a, cur, l=l, h=half_next: a.sub(
                cur[lay.fjx[l]],
                a.add(cur[lay.fjx[l + 1]],
                      a.mul(cur[lay.ftb[l]], a.c(h)))), f"fjxchain-{l}")
        ar(lambda a, cur: a.sub(cur[lay.hu], cur[lay.ff[lay.R - 1]]),
           "terminal-eq")

    the_air = air_m.Air(
        n=0,  # instance-dependent: set per Qc in attestation_air
        n_cols=lay.n_cols,
        periodic=periodic,
        constraints=cons,
        name=(f"ezt-recursion/{n_c}" if not lay.R
              else f"ezt-recursion/{n_c}/t{sch.n_stream * 4}"),
    )
    return the_air, lay, sch, per


@functools.lru_cache(maxsize=8)
def attestation_air(
    n_c: int, q_c: int, terminal: int | None = None
) -> Tuple[air_m.Air, Layout, Schedule, dict]:
    base, lay, sch, per = recursion_air(n_c, terminal=terminal)
    n = q_c * sch.L
    the_air = air_m.Air(
        n=n,
        n_cols=base.n_cols,
        periodic=base.periodic,
        constraints=base.constraints,
        name=base.name,
    )
    return the_air, lay, sch, per


# ---------------------------------------------------------------------------
# host helpers


def replay_child(header: dict, q_c: int):
    """The cheap O(header) transcript replay the aggregation verifier runs
    itself: derive the child's composition alphas, per-fold-layer betas,
    and query indices.  Mirrors stark.verify_chunk + fri_verify's replay
    (zero-layer children have no roots and an empty beta list)."""
    n_c = int(header["n"])
    iv = int(header["public"]["iv"])
    out = int(header["public"]["out"])
    gamma = int(header["public"]["gamma"])
    root = [int(x) for x in header["trace_root"]]
    coeffs = [int(c) for c in header["final_coeffs"]]
    roots = [[int(x) for x in r] for r in header.get("roots", [])]
    t = Transcript("ezt-chunk-stark")
    t.absorb("public", [n_c, iv, out, gamma])
    t.absorb("trace-root", root)
    alphas = t.challenges("alpha", 3)
    betas = []
    for r in roots:
        t.absorb("fri-root", r)
        betas.append(t.challenge("fri-beta"))
    t.absorb("fri-final", coeffs)
    indices = t.challenge_indices("fri-query", q_c, (4 * n_c) // 2)
    return alphas, betas, indices


def chain_digest(indices: List[int]) -> List[int]:
    """Poseidon chaining of the query indices — the single public value
    that binds every per-period index register inside the AIR."""
    chain = [0, 0, 0, 0]
    for idx in indices:
        st = chain + [idx % gl.P] + [0] * (W - 5)
        chain = poseidon.perm_host(st)[:4]
    return chain


def coeffs_digest(coeffs: List[int]) -> List[int]:
    """Sponge digest of the REVERSED terminal coefficients (the stream
    order the in-trace Horner consumes)."""
    return poseidon.hash_elements_host([int(c) % gl.P for c in reversed(coeffs)])


def child_header(child_proof: dict) -> dict:
    return {
        "n": child_proof["n"],
        "blowup": child_proof["blowup"],
        "shift": child_proof["shift"],
        "public": dict(child_proof["public"]),
        "trace_root": list(child_proof["trace_root"]),
        "final_coeffs": list(child_proof["fri"]["final_coeffs"]),
        # fold-layer commitment roots (empty for zero-layer children);
        # betas are transcript-derived from these on replay
        "roots": [list(r) for r in child_proof["fri"].get("roots", [])],
    }


def header_terminal(header: dict) -> int:
    """The child FRI's terminal size, recovered from the header: the
    terminal polynomial keeps terminal/blowup coefficients."""
    return 4 * len(header["final_coeffs"])


def _instance(header: dict, alphas, betas, indices):
    """Publics + boundary constraints for one attestation."""
    n_c = int(header["n"])
    terminal = header_terminal(header)
    root = [int(x) for x in header["trace_root"]]
    iv = int(header["public"]["iv"])
    out = int(header["public"]["out"])
    cd = coeffs_digest(header["final_coeffs"])
    chd = chain_digest(indices)
    lay = Layout(n_c, terminal)
    sch = Schedule(n_c, terminal)
    n = len(indices) * sch.L
    B = air_m.Boundary
    bnds = (
        [B(lay.root[j], 0, root[j]) for j in range(4)]
        + [B(lay.iv, 0, iv), B(lay.out, 0, out)]
        + [B(lay.alphas[j], 0, alphas[j]) for j in range(3)]
        + [B(lay.cd[j], 0, cd[j]) for j in range(4)]
        + [B(lay.chain[j], 0, 0) for j in range(4)]
        + [B(lay.chain[j], n - 1, chd[j]) for j in range(4)]
    )
    if lay.R:
        roots = [[int(x) for x in r] for r in header["roots"]]
        assert len(roots) == lay.R and len(betas) == lay.R
        for l in range(lay.R):
            bnds += [B(lay.froot[l][j], 0, roots[l][j]) for j in range(4)]
            bnds += [B(lay.fbeta[l], 0, betas[l])]
    publics = [n_c, len(indices), terminal]
    return publics, bnds


# ---------------------------------------------------------------------------
# trace construction (numpy, vectorized across the child's queries)

_RC_NP = None
_MDS_NP = None


def _pose_consts():
    global _RC_NP, _MDS_NP
    if _RC_NP is None:
        _RC_NP = np.array(poseidon.round_constants(), dtype=np.uint64)
        _MDS_NP = (
            np.array(poseidon.external_matrix(), dtype=np.uint64) % np.uint64(gl.P),
            np.array(poseidon.internal_matrix(), dtype=np.uint64) % np.uint64(gl.P),
        )
    return _RC_NP, _MDS_NP


def _matvec_np(mat: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(W, W) const matrix x (Q, W) rows -> (Q, W), mod p: one broadcast
    product (Q, W, W), then the sum over the matrix's columns."""
    prod = gl.np_mulmod(v[:, None, :], mat[None, :, :])
    acc = prod[:, :, 0]
    for j in range(1, W):
        acc = gl.np_addmod(acc, prod[:, :, j])
    return acc


def _perm_rows_np(state0: np.ndarray):
    """(Q, 12) input states -> (state_rows (Q, 32, 12),
    aux (Q, 32, 3, 12), final (Q, 12)).

    Poseidon2 slot layout: row 0 holds the INPUT state (pinned by leaf /
    load checks); the row-0 transition applies the initial external
    matrix; rows 1..30 hold the per-round states (aux at those rows);
    row 31 holds the final state (digest)."""
    rc, (me, mi) = _pose_consts()
    q = state0.shape[0]
    rows = np.zeros((q, SLOT, W), dtype=np.uint64)
    aux = np.zeros((q, SLOT, 3, W), dtype=np.uint64)
    s = state0.astype(np.uint64) % np.uint64(gl.P)
    mm, am = gl.np_mulmod, gl.np_addmod
    rows[:, 0] = s
    s = _matvec_np(me, s)  # initial linear layer
    for r in range(NR):
        row = 1 + r
        rows[:, row] = s
        t = am(s, rc[r][None, :])
        a2 = mm(t, t)
        a4 = mm(a2, a2)
        a6 = mm(a4, a2)
        aux[:, row, 0], aux[:, row, 1], aux[:, row, 2] = a2, a4, a6
        so = mm(a6, t)
        if _is_full_round(r):
            s = _matvec_np(me, so)
        else:
            out = t.copy()
            out[:, 0] = so[:, 0]
            s = _matvec_np(mi, out)
    rows[:, NR + 1] = s
    return rows, aux, s


def build_verifier_trace(child_proof: dict, q_c: int):
    """Transcribe the child proof's query checks into an AIR trace.

    Returns (air, trace, publics, boundaries), the trace an (n, C) numpy
    uint64 array on the host.  The function just transcribes — an INVALID
    child proof produces a constraint-violating trace, which air.prove
    rejects (FRI terminal-degree gate)."""
    n_c = int(child_proof["n"])
    m_c = 4 * n_c
    header = child_header(child_proof)
    terminal = header_terminal(header)
    air, lay, sch, per = attestation_air(n_c, q_c, terminal)
    alphas, betas, indices = replay_child(header, q_c)
    assert len(child_proof["fri"]["queries"]) == q_c
    shift_c = int(child_proof["shift"])
    gamma = int(child_proof["public"]["gamma"])
    iv = int(child_proof["public"]["iv"])
    out_v = int(child_proof["public"]["out"])
    root = [int(x) for x in child_proof["trace_root"]]
    coeffs = [int(c) for c in child_proof["fri"]["final_coeffs"]]
    assert len(coeffs) == sch.n_stream, "terminal coefficient count mismatch"
    rev = [c % gl.P for c in reversed(coeffs)]
    w_m = gl.primitive_root_of_unity(m_c)
    w_last_c = gl.h_pow(gl.primitive_root_of_unity(n_c), n_c - 1)
    openings = child_proof["trace_openings"]
    assert len(openings) == q_c
    Q = q_c
    L = sch.L
    C = lay.n_cols
    tr = np.zeros((Q, L, C), dtype=np.uint64)
    mm, am, sm = gl.np_mulmod, gl.np_addmod, gl.np_submod

    # --- per-query parsed data ----------------------------------------------
    la = np.zeros((Q, 4), dtype=np.uint64)
    ld = np.zeros((Q, 4), dtype=np.uint64)
    paths = np.zeros((Q, 4, sch.depth, 4), dtype=np.uint64)
    idxs = np.zeros((Q, 4), dtype=np.int64)
    for q in range(Q):
        ent = openings[q]
        assert len(ent) == 4
        for p in range(4):
            row = [int(x) for x in ent[p]["row"]]
            la[q, p], ld[q, p] = row[0] % gl.P, row[1] % gl.P
            idxs[q, p] = int(ent[p]["index"])
            pth = ent[p]["path"]
            assert len(pth) == sch.depth
            for k in range(sch.depth):
                paths[q, p, k] = [int(x) % gl.P for x in pth[k]]

    # --- trace-persistent / per-period registers -----------------------------
    for j in range(4):
        tr[:, :, lay.root[j]] = root[j]
        tr[:, :, lay.cd[j]] = coeffs_digest(coeffs)[j]
    tr[:, :, lay.iv] = iv
    tr[:, :, lay.out] = out_v
    for j in range(3):
        tr[:, :, lay.alphas[j]] = alphas[j]
    if lay.R:
        froots = [[int(x) for x in r] for r in child_proof["fri"]["roots"]]
        assert len(froots) == lay.R
        for l in range(lay.R):
            tr[:, :, lay.fbeta[l]] = betas[l] % gl.P
            for j in range(4):
                tr[:, :, lay.froot[l][j]] = froots[l][j] % gl.P
    for p in range(4):
        tr[:, :, lay.la[p]] = la[:, p : p + 1]
        tr[:, :, lay.ld[p]] = ld[:, p : p + 1]

    def fill_perm(slot: int, st0: np.ndarray) -> np.ndarray:
        """Run one permutation slot for all queries; fill state + aux
        columns; return the (Q, 12) output state."""
        rows, aux, fin = _perm_rows_np(st0)
        b = slot * SLOT
        for i in range(W):
            tr[:, b : b + SLOT, lay.state[i]] = rows[:, :, i]
            tr[:, b : b + SLOT, lay.a2[i]] = aux[:, :, 0, i]
            tr[:, b : b + SLOT, lay.a4[i]] = aux[:, :, 1, i]
            tr[:, b : b + SLOT, lay.a6[i]] = aux[:, :, 2, i]
        return fin

    # --- Merkle paths (slots are query-parallel) ------------------------------
    jj = idxs[:, 0]  # the pair index of each query
    for p in range(4):
        base_slot = p * (1 + sch.depth)
        st0 = np.zeros((Q, W), dtype=np.uint64)
        st0[:, 0], st0[:, 1] = la[:, p], ld[:, p]
        st0[:, RATE] = 2
        # iacc: 0 during the leaf slot
        b0 = base_slot * SLOT
        tr[:, b0 : b0 + SLOT, lay.iacc] = 0
        dig = fill_perm(base_slot, st0)
        run_idx = np.zeros(Q, dtype=np.int64)
        for k in range(sch.depth):
            slot = base_slot + 1 + k
            load_row = slot * SLOT - 1
            bit = (idxs[:, p] >> k) & 1
            sib = paths[:, p, k]  # (Q, 4)
            tr[:, load_row, lay.bit] = bit.astype(np.uint64)
            for j in range(4):
                tr[:, load_row, lay.sib[j]] = sib[:, j]
            if p == 0:
                wk = gl.h_pow(w_m, 1 << k)
                tr[:, load_row, lay.bw] = mm(
                    bit.astype(np.uint64), np.uint64(wk)
                )
            run_idx = run_idx + (bit.astype(np.int64) << k)
            st0 = np.zeros((Q, W), dtype=np.uint64)
            bitu = bit.astype(np.uint64)
            for j in range(4):
                # left = bit ? sib : dig ; right = bit ? dig : sib
                st0[:, j] = np.where(bit == 1, sib[:, j], dig[:, j])
                st0[:, 4 + j] = np.where(bit == 1, dig[:, j], sib[:, j])
            b = slot * SLOT
            tr[:, b : b + SLOT, lay.iacc] = run_idx.astype(np.uint64)[:, None]
            dig = fill_perm(slot, st0)

    # iacc holds the last path's final index from the idx slot to period
    # end (path 3 for zero-layer; filled again below for fold layers)
    tr[:, sch.idx_slot * SLOT :, lay.iacc] = (
        idxs[:, 3].astype(np.uint64)[:, None]
    )

    # idx1 register: jj from the end of path 0 onward (h_idx1 holds it;
    # rows before the set are free — fill uniformly for simplicity)
    tr[:, :, lay.idx1] = jj.astype(np.uint64)[:, None]

    # xacc: shift * w^(prefix of jj) during path-0 slots, final value after
    xval = np.full(Q, shift_c % gl.P, dtype=np.uint64)
    tr[:, 0 : SLOT, lay.xacc] = xval[:, None]  # leaf_0 slot
    for k in range(sch.depth):
        slot = 1 + k
        bit = ((jj >> k) & 1).astype(np.uint64)
        wk = gl.h_pow(w_m, 1 << k)
        fac = np.where(bit == 1, np.uint64(wk), np.uint64(1))
        xval = mm(xval, fac)
        b = slot * SLOT
        tr[:, b:, lay.xacc] = xval[:, None]  # forward fill to period end
    x_u = xval  # shift * w^jj

    # --- fold-layer paths + registers (R >= 1) --------------------------------
    if lay.R:
        qlayers = [child_proof["fri"]["queries"][q]["layers"] for q in range(Q)]
        x_l = x_u.copy()  # x_0 = shift * w^jj
        shift_l = shift_c % gl.P
        ff_prev = None
        inv2 = (gl.P + 1) // 2
        for l in range(lay.R):
            half_l = m_c >> (l + 1)
            d_l = sch.fdepth[l]
            jj_l = (jj & (half_l - 1)).astype(np.int64)
            u_l = np.array(
                [int(qlayers[q][l]["u"]) % gl.P for q in range(Q)], np.uint64
            )
            v_l = np.array(
                [int(qlayers[q][l]["v"]) % gl.P for q in range(Q)], np.uint64
            )
            tb_l = ((jj_l >> (d_l - 1)) & 1).astype(np.uint64)
            # fold value f_l = (u+v)/2 + beta*(u-v)/(2x)
            x_inv = np.array(
                [gl.h_inv(int(x)) for x in x_l], dtype=np.uint64
            )
            even = mm(am(u_l, v_l), np.uint64(inv2))
            odd = mm(mm(mm(sm(u_l, v_l), np.uint64(inv2)), x_inv),
                     np.uint64(betas[l] % gl.P))
            f_l = am(even, odd)
            y_l = mm(x_l, x_l)
            tr[:, :, lay.fu[l]] = u_l[:, None]
            tr[:, :, lay.fv[l]] = v_l[:, None]
            tr[:, :, lay.fx[l]] = x_l[:, None]
            tr[:, :, lay.fy[l]] = y_l[:, None]
            tr[:, :, lay.ff[l]] = f_l[:, None]
            tr[:, :, lay.ftb[l]] = tb_l[:, None]
            tr[:, :, lay.fjx[l]] = jj_l.astype(np.uint64)[:, None]
            # Merkle path slots (identical machinery to the trace paths)
            base_slot = sch.fleaf_slots[l]
            st0 = np.zeros((Q, W), dtype=np.uint64)
            st0[:, 0], st0[:, 1] = u_l, v_l
            st0[:, RATE] = 2
            b0 = base_slot * SLOT
            tr[:, b0 : b0 + SLOT, lay.iacc] = 0
            dig = fill_perm(base_slot, st0)
            run_idx = np.zeros(Q, dtype=np.int64)
            for k in range(d_l):
                slot = base_slot + 1 + k
                load_row = slot * SLOT - 1
                bit = (jj_l >> k) & 1
                sib = np.array(
                    [
                        [int(x) % gl.P for x in qlayers[q][l]["path"][k]]
                        for q in range(Q)
                    ],
                    dtype=np.uint64,
                )
                tr[:, load_row, lay.bit] = bit.astype(np.uint64)
                for j in range(4):
                    tr[:, load_row, lay.sib[j]] = sib[:, j]
                run_idx = run_idx + (bit.astype(np.int64) << k)
                st0 = np.zeros((Q, W), dtype=np.uint64)
                for j in range(4):
                    st0[:, j] = np.where(bit == 1, sib[:, j], dig[:, j])
                    st0[:, 4 + j] = np.where(bit == 1, dig[:, j], sib[:, j])
                b = slot * SLOT
                tr[:, b : b + SLOT, lay.iacc] = run_idx.astype(np.uint64)[:, None]
                dig = fill_perm(slot, st0)
            # next layer's x: (-1)^tb * x^2
            x_l = np.where(tb_l == 1, sm(np.zeros_like(y_l), y_l), y_l)
            ff_prev = f_l
        x_term = mm(
            tr[:, 0, lay.fx[lay.R - 1]], tr[:, 0, lay.fx[lay.R - 1]]
        )  # = fy[R-1]
        # iacc holds the LAST fold path's index to period end (overrides
        # the zero-layer fill below)
        last_jj = tr[:, 0, lay.fjx[lay.R - 1]]
        ff_last = ff_prev

    # --- idx chain slot (sequential across queries) ----------------------------
    chain_prev = np.zeros((Q, 4), dtype=np.uint64)
    chain = [0, 0, 0, 0]
    for q in range(Q):
        chain_prev[q] = chain
        st = chain + [int(jj[q]) % gl.P] + [0] * (W - 5)
        chain = poseidon.perm_host(st)[:4]
    chain_dig = chain
    st0 = np.zeros((Q, W), dtype=np.uint64)
    st0[:, :4] = chain_prev
    st0[:, 4] = jj.astype(np.uint64)
    chain_out = fill_perm(sch.idx_slot, st0)
    # chain register: prev value through the chainx row, new value after
    cx = sch.chainx_row
    for j in range(4):
        tr[:, : cx + 1, lay.chain[j]] = chain_prev[:, j : j + 1]
        tr[:, cx + 1 :, lay.chain[j]] = chain_out[:, j : j + 1]

    # iacc hold fix for fold layers (see fold block above)
    if lay.R:
        tr[:, sch.idx_slot * SLOT :, lay.iacc] = last_jj[:, None]

    # --- coefficient stream: sponge + Horner ------------------------------------
    # zero-layer children: DUAL Horner at (x, -x) against the composition;
    # fold-layer children: ONE Horner at the terminal point x_term =
    # fy[R-1], checked against the last fold value
    hu = np.zeros(Q, dtype=np.uint64)
    hv = np.zeros(Q, dtype=np.uint64)
    arg_u = x_term if lay.R else x_u
    neg_x = sm(np.zeros_like(x_u), x_u)
    st = np.zeros((Q, W), dtype=np.uint64)
    st[:, RATE] = sch.n_stream
    hsteps = min(RATE, sch.n_stream)
    for b_i in range(sch.n_blocks):
        slot = sch.stream0_slot + b_i
        b = slot * SLOT
        block = rev[b_i * RATE : b_i * RATE + hsteps]
        # D columns hold the block over rows 0..hsteps-1
        for j in range(hsteps):
            tr[:, b : b + hsteps, lay.D[j]] = np.uint64(block[j])
        # absorb into sponge lanes
        st = st.copy()
        for j in range(hsteps):
            st[:, j] = am(st[:, j], np.full(Q, block[j], dtype=np.uint64))
        # horner rows: acc at row b..b+hsteps (value BEFORE each step)
        for r in range(hsteps):
            tr[:, b + r, lay.hu] = hu
            tr[:, b + r, lay.hv] = hv
            hu = am(mm(hu, arg_u), np.uint64(block[r]))
            hv = am(mm(hv, neg_x), np.uint64(block[r]))
        # rows hsteps..31 hold the post-step values
        tr[:, b + hsteps : b + SLOT, lay.hu] = hu[:, None]
        tr[:, b + hsteps : b + SLOT, lay.hv] = hv[:, None]
        st = fill_perm(slot, st)
    # hu/hv hold through the pads to period end
    pe = (sch.last_stream_slot + 1) * SLOT
    tr[:, pe:, lay.hu] = hu[:, None]
    tr[:, pe:, lay.hv] = hv[:, None]
    # pads: state holds
    for s_i in range(sch.last_stream_slot + 1, len(sch.slots)):
        b = s_i * SLOT
        for i in range(W):
            tr[:, b : b + SLOT, lay.state[i]] = st[:, i : i + 1]

    # --- arithmetic scratch registers (period-constant) -------------------------
    sq = mm(x_u, x_u)
    for k in range(lay.k_sq):
        tr[:, :, lay.sq[k]] = sq[:, None]
        if k + 1 < lay.k_sq:
            sq = mm(sq, sq)
    xn = sq  # x^n_c

    def inv_np(v):
        return np.array(
            [gl.h_inv(int(x)) if int(x) else 0 for x in v], dtype=np.uint64
        )

    one = np.ones(Q, dtype=np.uint64)
    zinv = inv_np(sm(xn, one))
    i1u = inv_np(sm(x_u, one))
    iwu = inv_np(sm(x_u, np.full(Q, w_last_c, dtype=np.uint64)))
    i1v = inv_np(sm(neg_x, one))
    iwv = inv_np(sm(neg_x, np.full(Q, w_last_c, dtype=np.uint64)))
    gam = np.uint64(gamma)
    c1u = sm(sm(la[:, 1], mm(np.full(Q, gam, dtype=np.uint64), la[:, 0])), ld[:, 0])
    c1v = sm(sm(la[:, 3], mm(np.full(Q, gam, dtype=np.uint64), la[:, 2])), ld[:, 2])
    tu = mm(c1u, sm(x_u, np.full(Q, w_last_c, dtype=np.uint64)))
    tv = mm(c1v, sm(neg_x, np.full(Q, w_last_c, dtype=np.uint64)))
    q1u, q1v = mm(tu, zinv), mm(tv, zinv)
    ivv = np.full(Q, iv, dtype=np.uint64)
    ouv = np.full(Q, out_v, dtype=np.uint64)
    q2u = mm(sm(la[:, 0], ivv), i1u)
    q3u = mm(sm(la[:, 0], ouv), iwu)
    q2v = mm(sm(la[:, 2], ivv), i1v)
    q3v = mm(sm(la[:, 2], ouv), iwv)
    a1, a2_, a3 = (np.full(Q, alphas[j], dtype=np.uint64) for j in range(3))
    su = am(mm(a2_, q2u), mm(a3, q3u))
    sv = am(mm(a2_, q2v), mm(a3, q3v))
    for col, v in [
        (lay.zinv, zinv), (lay.i1u, i1u), (lay.iwu, iwu), (lay.i1v, i1v),
        (lay.iwv, iwv), (lay.tu, tu), (lay.tv, tv), (lay.q1u, q1u),
        (lay.q1v, q1v), (lay.q2u, q2u), (lay.q3u, q3u), (lay.q2v, q2v),
        (lay.q3v, q3v), (lay.su, su), (lay.sv, sv),
    ]:
        tr[:, :, col] = v[:, None]

    # cb: wrap bit for path 3's index relation
    cb = ((jj + m_c // 2 + 4) >= m_c).astype(np.uint64)
    tr[:, :, lay.cb] = cb[:, None]

    trace = tr.reshape(Q * L, C)
    publics, bnds = _instance(header, alphas, betas, indices)
    return air, trace, publics, bnds


# ---------------------------------------------------------------------------
# attestation API


def attest_chunk(child_proof: dict, num_queries_agg: int = 30, *, device) -> dict:
    """Prove 'this chunk proof verifies' on `device` — the recursive
    aggregation step.  Raises (via air.prove's degree gate) if the chunk
    proof is invalid."""
    q_c = len(child_proof["fri"]["queries"])
    air, trace, publics, bnds = build_verifier_trace(child_proof, q_c)
    air_m.stage("trace")
    air_proof = air_m.prove(air, gl.from_int(trace, device), publics, bnds,
                            num_queries=num_queries_agg)
    return {
        "type": "chunk-attested",
        "q_c": q_c,
        "header": child_header(child_proof),
        "air_proof": air_proof,
    }


def attest_chunk_wrap(child_proof: dict, num_queries_wrap: int = 2, grind_bits: int = 0,
                      ext_blowup: int = 8, *, device) -> dict:
    """attest_chunk in the wrap profile (models/air_wrap.py), on `device`:
    the same verifier AIR and trace, committed with Poseidon2-Fr trees so
    that the Groth16 final circuit verifies the attestation in-circuit.
    The wrap STARK's own soundness: num_queries_wrap FRI queries at ratio
    ext_blowup/2 plus grind_bits of proof of work."""
    q_c = len(child_proof["fri"]["queries"])
    air, trace, publics, bnds = build_verifier_trace(child_proof, q_c)
    if ext_blowup != air.ext_blowup:
        air = dataclasses.replace(air, ext_blowup=ext_blowup)
    air_m.stage("trace")
    wrap_proof = air_wrap.prove_wrap(air, gl.from_int(trace, device), publics, bnds,
                                     num_queries=num_queries_wrap, grind_bits=grind_bits)
    return {
        "type": "chunk-attested-wrap",
        "q_c": q_c,
        "header": child_header(child_proof),
        "wrap_proof": wrap_proof,
    }


def _pinned_instance(att: dict, expected_queries, expected_rows, expected_terminal):
    """Pin an attestation's header to the protocol and replay the child's
    transcript: (header, q_c, n_c, terminal, publics, boundaries).  Raises
    ValueError on any mismatch."""
    header = att["header"]
    q_c = int(att["q_c"])
    n_c = int(header["n"])
    if expected_queries is not None and q_c != expected_queries:
        raise ValueError(f"attestation query count {q_c} != protocol {expected_queries}")
    if expected_rows is not None and n_c != expected_rows:
        raise ValueError(f"attested trace size {n_c} != protocol {expected_rows}")
    if int(header["blowup"]) != 4:
        raise ValueError("unsupported child blowup")
    if int(header["public"]["gamma"]) != chunk_gamma():
        raise ValueError("gamma mismatch")
    terminal = header_terminal(header)
    if expected_terminal is not None and terminal != expected_terminal:
        raise ValueError(
            f"attested terminal size {terminal} != protocol {expected_terminal}"
        )
    if expected_terminal is None and terminal != 4 * n_c:
        # default protocol shape is the zero-layer child; fold-layer
        # attestations must be explicitly pinned by the caller
        raise ValueError("fold-layer attestation without pinned terminal")
    R = n_fold_layers(n_c, terminal)
    if len(header.get("roots", [])) != R:
        raise ValueError("fold-layer root count mismatch")
    if int(header["shift"]) != gl.MULTIPLICATIVE_GENERATOR:
        raise ValueError("unsupported child coset shift")
    alphas, betas, indices = replay_child(header, q_c)
    publics, bnds = _instance(header, alphas, betas, indices)
    return header, q_c, n_c, terminal, publics, bnds


def wrap_attestation_instance(att: dict, expected_queries: Optional[int] = None,
                              expected_rows: Optional[int] = None,
                              expected_terminal: Optional[int] = None,
                              wrap_blowup: int = 8) -> tuple:
    """Pin and replay a wrap attestation's instance without verifying the
    proof: (air, publics, boundaries).  Shared by the host checker
    (verify_attestation_wrap) and the Groth16 circuit builder."""
    _, q_c, n_c, terminal, publics, bnds = _pinned_instance(
        att, expected_queries, expected_rows, expected_terminal)
    air, _, _, _ = attestation_air(n_c, q_c, terminal)
    if wrap_blowup != air.ext_blowup:
        air = dataclasses.replace(air, ext_blowup=wrap_blowup)
    return air, publics, bnds


def verify_attestation_wrap(att: dict, expected_queries: Optional[int] = None,
                            expected_rows: Optional[int] = None,
                            expected_terminal: Optional[int] = None,
                            expected_wrap_queries: Optional[int] = None,
                            expected_wrap_grind: Optional[int] = None,
                            wrap_blowup: int = 8, *, device) -> List[int]:
    """Host check of a wrap-profile attestation; returns the chunk digest.
    Raises ValueError on failure.  expected_wrap_queries /
    expected_wrap_grind pin the wrap STARK's own soundness parameters;
    `device` commits the AIR's constants tree (once per device)."""
    air, publics, bnds = wrap_attestation_instance(
        att, expected_queries, expected_rows, expected_terminal, wrap_blowup=wrap_blowup)
    if not air_wrap.verify_wrap(air, att["wrap_proof"], publics, bnds,
                                expected_queries=expected_wrap_queries,
                                expected_grind_bits=expected_wrap_grind, device=device):
        raise ValueError("wrap verifier-AIR proof rejected")
    from ..protocol.prover_service import chunk_digest as _cd

    return _cd(att["header"])


def verify_attestation(
    att: dict,
    expected_queries: Optional[int] = None,
    expected_rows: Optional[int] = None,
    expected_terminal: Optional[int] = None,
) -> List[int]:
    """Check an attestation WITHOUT the child proof's openings; returns the
    chunk digest.  Raises ValueError on any failure.

    expected_queries/expected_rows MUST be pinned by the caller to the
    protocol's chunk parameters: q_c and n are attacker-influenced fields
    of the attestation, and a forger who could shrink the query count (or
    the trace size) would be attesting a strictly weaker statement —
    e.g. a 1-query check of a ground-out forged chunk proof."""
    header, q_c, n_c, terminal, publics, bnds = _pinned_instance(
        att, expected_queries, expected_rows, expected_terminal)
    air, _, _, _ = attestation_air(n_c, q_c, terminal)
    if not air_m.verify(air, att["air_proof"], publics, bnds):
        raise ValueError("verifier-AIR proof rejected")
    from ..protocol.prover_service import chunk_digest as _cd

    return _cd(header)

