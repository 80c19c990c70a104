"""BN254 optimal ate pairing — host-side (python int) verifier math.

Copy of eigen_zeth_tpu/ops/pairing.py, used by the Groth16 verifier
(models/groth16.py) to check e(A,B) = e(α,β)·e(pub,γ)·e(C,δ).

Tower: Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³-ξ) with ξ = 9+u,
Fq12 = Fq6[w]/(w²-v).  Optimal ate: Miller loop over 6t+2 with the two
Frobenius correction lines, then final exponentiation.

BN parameter t = 4965661367192848881 (the standard alt_bn128 curve).
"""

from __future__ import annotations

from .bn254 import Q, h_fq2_inv, h_fq2_mul

T_PARAM = 4965661367192848881
ATE_LOOP = 6 * T_PARAM + 2  # 29793968203157093288

XI = (9, 1)  # ξ = 9 + u, the Fq6/Fq2 non-residue


# ---------------------------------------------------------------------------
# Fq2 helpers (elements are (c0, c1) int tuples)


def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


f2_mul = h_fq2_mul
f2_inv = h_fq2_inv


def f2_scalar(a, k):
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def f2_conj(a):
    return (a[0], (-a[1]) % Q)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - ξ): elements (c0, c1, c2) of Fq2


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2)
    )
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(
        f2_add(_mul_xi(f2_mul(a2, c1)), _mul_xi(f2_mul(a1, c2))), f2_mul(a0, c0)
    )
    t_inv = f2_inv(t)
    return (f2_mul(c0, t_inv), f2_mul(c1, t_inv), f2_mul(c2, t_inv))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v): elements (c0, c1) of Fq6


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    # v·t1: multiply Fq6 element by v (cyclic shift with ξ)
    t1v = (_mul_xi(t1[2]), t1[0], t1[1])
    c0 = f6_add(t0, t1v)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t0 = f6_mul(a0, a0)
    t1 = f6_mul(a1, a1)
    t1v = (_mul_xi(t1[2]), t1[0], t1[1])
    t = f6_sub(t0, t1v)
    t_inv = f6_inv(t)
    return (f6_mul(a0, t_inv), f6_neg(f6_mul(a1, t_inv)))


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sq(base)
        e >>= 1
    return result


F12_ONE = (F6_ONE, F6_ZERO)


# Frobenius coefficients: γ_{1,i} = ξ^((i(q-1))/6) for w^i terms
def _frob_coeffs():
    out = []
    for i in range(6):
        e = (Q - 1) * i // 6
        # ξ^e in Fq2
        b = XI
        acc = F2_ONE
        ee = e
        while ee:
            if ee & 1:
                acc = f2_mul(acc, b)
            b = f2_mul(b, b)
            ee >>= 1
        out.append(acc)
    return out


_FC = _frob_coeffs()


def f12_frobenius(a):
    """a^q via coefficient-wise conjugation + γ coefficients."""
    a0, a1 = a
    c0 = (f2_conj(a0[0]), f2_mul(f2_conj(a0[1]), _FC[2]), f2_mul(f2_conj(a0[2]), _FC[4]))
    c1 = (
        f2_mul(f2_conj(a1[0]), _FC[1]),
        f2_mul(f2_conj(a1[1]), _FC[3]),
        f2_mul(f2_conj(a1[2]), _FC[5]),
    )
    return (c0, c1)


def f12_frobenius_p2(a):
    return f12_frobenius(f12_frobenius(a))


# ---------------------------------------------------------------------------
# Miller loop (optimal ate): G1 point P=(x,y) ints, G2 point Q2=(X,Y) Fq2


def _g2_double_eval(r, p):
    """Double R (Jacobian-free affine-ish projective) and evaluate the
    tangent line at P.  Projective coordinates (X, Y, Z) over Fq2."""
    X, Y, Z = r
    px, py = p
    # standard projective doubling with line evaluation (bn formulas)
    A = f2_mul(X, Y)
    A = f2_scalar(A, pow(2, -1, Q))
    B = f2_mul(Y, Y)
    C = f2_mul(Z, Z)
    D = f2_add(f2_add(C, C), C)
    b2 = f2_mul((3, 0), f2_inv(XI))  # b' = 3/ξ  (twist coefficient)
    E = f2_mul(b2, D)
    F = f2_add(f2_add(E, E), E)
    G = f2_scalar(f2_add(B, F), pow(2, -1, Q))
    H = f2_sub(f2_mul(f2_add(Y, Z), f2_add(Y, Z)), f2_add(B, C))
    I = f2_sub(E, B)
    J = f2_mul(X, X)
    E2 = f2_mul(E, E)
    X3 = f2_mul(A, f2_sub(B, F))
    Y3 = f2_sub(f2_mul(G, G), f2_add(f2_add(E2, E2), E2))
    Z3 = f2_mul(B, H)
    # line: l(P) = H·(-py) + 3X²·px·w + I·w³ … assembled in Fq12 sparse form
    l00 = f2_scalar(H, (-py) % Q)  # coefficient of 1 (times Fq2)
    l1 = f2_scalar(J, (3 * px) % Q)  # w^2-ish slot (twist layout)
    l2 = I
    return (X3, Y3, Z3), (l00, l1, l2)


def _g2_add_eval(r, q2, p):
    """Add affine Q2 into projective R; evaluate the line at P."""
    X, Y, Z = r
    qx, qy = q2
    px, py = p
    t = f2_sub(Y, f2_mul(qy, Z))  # θ = Y - y2·Z
    l = f2_sub(X, f2_mul(qx, Z))  # λ = X - x2·Z
    C = f2_mul(t, t)
    D = f2_mul(l, l)
    E = f2_mul(l, D)
    F = f2_mul(Z, C)
    G = f2_mul(X, D)
    H = f2_add(f2_sub(E, f2_add(G, G)), F)
    X3 = f2_mul(l, H)
    Y3 = f2_sub(f2_mul(t, f2_sub(G, H)), f2_mul(E, Y))
    Z3 = f2_mul(Z, E)
    J = f2_sub(f2_mul(t, qx), f2_mul(l, qy))
    l00 = f2_scalar(l, py)
    l1 = f2_scalar(t, (-px) % Q)
    l2 = J
    return (X3, Y3, Z3), (l00, l1, l2)


def _line_to_f12(line):
    """Sparse line (l0, l1, l2) -> Fq12 element (D-type twist layout):
    l0 + l1·w + l2·w³  ==  (c0=(l0,0,0), c1=(l1,l2,0))? — use the common
    ell: f · (l0 + l1·w + l2·w³) with l0∈Fq2·1, l1·w, l2·w³."""
    c0 = (line[0], F2_ZERO, F2_ZERO)
    c1 = (line[1], line[2], F2_ZERO)
    return (c0, c1)


def miller_loop(p, q2):
    """Optimal ate Miller loop f_{6t+2,Q}(P) with Frobenius corrections."""
    if p is None or q2 is None:
        return F12_ONE
    px, py = p
    r = (q2[0], q2[1], F2_ONE)
    f = F12_ONE
    naf = _naf(ATE_LOOP)
    for bit in naf[-2::-1]:
        f = f12_sq(f)
        r, line = _g2_double_eval(r, p)
        f = f12_mul(f, _line_to_f12(line))
        if bit == 1:
            r, line = _g2_add_eval(r, q2, p)
            f = f12_mul(f, _line_to_f12(line))
        elif bit == -1:
            nq = (q2[0], f2_neg(q2[1]))
            r, line = _g2_add_eval(r, nq, p)
            f = f12_mul(f, _line_to_f12(line))
    # Frobenius correction points: Q1 = π(Q), Q2c = -π²(Q)
    q1 = _g2_frobenius(q2)
    q2c = _g2_frobenius(q1)
    q2c = (q2c[0], f2_neg(q2c[1]))
    r, line = _g2_add_eval(r, q1, p)
    f = f12_mul(f, _line_to_f12(line))
    r, line = _g2_add_eval(r, q2c, p)
    f = f12_mul(f, _line_to_f12(line))
    return f


def _naf(x: int):
    out = []
    while x:
        if x & 1:
            z = 2 - (x % 4)
            out.append(z)
            x -= z
        else:
            out.append(0)
        x //= 2
    return out


# Frobenius on G2 (twist): π(x, y) = (x^q·γ12, y^q·γ13)
_G2_FROB_X = None
_G2_FROB_Y = None


def _init_g2_frob():
    global _G2_FROB_X, _G2_FROB_Y
    # γ12 = ξ^((q-1)/3), γ13 = ξ^((q-1)/2)
    def xi_pow(e):
        b, acc = XI, F2_ONE
        while e:
            if e & 1:
                acc = f2_mul(acc, b)
            b = f2_mul(b, b)
            e >>= 1
        return acc

    _G2_FROB_X = xi_pow((Q - 1) // 3)
    _G2_FROB_Y = xi_pow((Q - 1) // 2)


_init_g2_frob()


def _g2_frobenius(q2):
    x, y = q2
    return (f2_mul(f2_conj(x), _G2_FROB_X), f2_mul(f2_conj(y), _G2_FROB_Y))


def final_exponentiation(f):
    """f^((q^12-1)/r): easy part then hard part by plain exponentiation.

    The hard part uses the generic (q^4 - q^2 + 1)/r exponent — slower
    than the t-addition-chain version but unambiguous; verification is
    host-side and runs a handful of times per proof."""
    # easy: f^(q^6-1) = conj(f)/f ; then ^(q^2+1)
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    f2 = f12_mul(f12_frobenius_p2(f1), f1)
    # hard: ^((q^4 - q^2 + 1)/r)
    from .bn254 import R as _R

    hard = (Q**4 - Q**2 + 1) // _R
    return f12_pow(f2, hard)


def pairing(p, q2):
    """e(P, Q) for affine G1 P=(x,y) and affine G2 Q=((x0,x1),(y0,y1))."""
    return final_exponentiation(miller_loop(p, q2))
