"""Finite field GF(p^k) arithmetic for triangle-block constructions.

The affine/projective plane constructions of the paper (§VI) require a finite
field of order c for any prime power c.  Elements are represented as integers
in ``[0, q)`` encoding polynomial coefficients base-p (little-endian); add and
mul are table-driven for speed and simplicity (fields used here are tiny —
c ≤ a few hundred).

A copy of :mod:`repro.core.gf` for the port: same names,
same results.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# Irreducible (Conway where convenient) polynomials over GF(p), encoded as the
# coefficient list of x^k + ... (monic, little-endian, without leading 1).
# Entry (p, k) -> coeffs c_0..c_{k-1} of the reduction polynomial
#   x^k = -(c_{k-1} x^{k-1} + ... + c_0)  (mod p)
_IRREDUCIBLE: Dict[Tuple[int, int], List[int]] = {
    (2, 2): [1, 1],          # x^2 + x + 1
    (2, 3): [1, 1, 0],       # x^3 + x + 1
    (2, 4): [1, 1, 0, 0],    # x^4 + x + 1
    (2, 5): [1, 0, 1, 0, 0],  # x^5 + x^2 + 1
    (2, 6): [1, 1, 0, 0, 0, 0],  # x^6 + x + 1
    (3, 2): [1, 0],          # x^2 + 1 (no roots mod 3)
    (3, 3): [1, 2, 0],       # x^3 + 2x + 1
    (5, 2): [2, 1],          # x^2 + x + 2
    (7, 2): [3, 1],          # x^2 + x + 3
    (11, 2): [7, 1],
    (13, 2): [2, 1],
}


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def prime_power(q: int) -> Tuple[int, int] | None:
    """Return (p, k) with q == p**k for prime p, else None."""
    if q < 2:
        return None
    for p in range(2, q + 1):
        if p * p > q:
            break
        if q % p == 0:
            if not is_prime(p):
                return None
            k = 0
            m = q
            while m % p == 0:
                m //= p
                k += 1
            return (p, k) if m == 1 else None
    return (q, 1) if is_prime(q) else None


def _poly_mul_mod(a: int, b: int, p: int, k: int, red: List[int]) -> int:
    """Multiply field elements a*b with reduction poly ``red`` (base-p digits)."""
    # decompose into digits
    da = [(a // p**i) % p for i in range(k)]
    db = [(b // p**i) % p for i in range(k)]
    prod = [0] * (2 * k - 1)
    for i, x in enumerate(da):
        if x == 0:
            continue
        for j, y in enumerate(db):
            prod[i + j] = (prod[i + j] + x * y) % p
    # reduce: x^k = -red
    for deg in range(2 * k - 2, k - 1, -1):
        coef = prod[deg]
        if coef == 0:
            continue
        prod[deg] = 0
        for j, r in enumerate(red):
            prod[deg - k + j] = (prod[deg - k + j] - coef * r) % p
    return sum(prod[i] * p**i for i in range(k))


def _is_field_reduction(p: int, k: int, red: List[int]) -> bool:
    """True iff GF(p)[x]/(x^k + red) is a field (i.e. red gives an
    irreducible monic polynomial): every nonzero element has an inverse,
    equivalently no zero divisors."""
    q = p**k
    for a in range(1, q):
        has_inv = False
        for b in range(1, q):
            m = _poly_mul_mod(a, b, p, k, red)
            if m == 0:
                return False  # zero divisor
            if m == 1:
                has_inv = True
        if not has_inv:
            return False
    return True


def _find_irreducible(p: int, k: int) -> List[int]:
    """Brute-force search for an irreducible monic degree-k poly over GF(p).

    Fields used here are tiny (q ≤ a few hundred) so the O(q^3) zero-divisor
    check per candidate is fine and is the simplest correct criterion.
    """
    for enc in range(p**k):
        red = [(enc // p**i) % p for i in range(k)]
        # quick screen: no linear roots (necessary for irreducibility)
        if any((pow(r, k, p) + sum(red[i] * pow(r, i, p) for i in range(k))) % p == 0
               for r in range(p)):
            continue
        if _is_field_reduction(p, k, red):
            return red
    raise ValueError(f"no irreducible polynomial found for GF({p}^{k})")


@dataclass
class GF:
    """A tiny table-driven finite field of order q = p^k."""

    q: int
    p: int = field(init=False)
    k: int = field(init=False)
    add_table: np.ndarray = field(init=False, repr=False)
    mul_table: np.ndarray = field(init=False, repr=False)
    neg_table: np.ndarray = field(init=False, repr=False)
    inv_table: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        pk = prime_power(self.q)
        if pk is None:
            raise ValueError(f"{self.q} is not a prime power")
        self.p, self.k = pk
        p, k, q = self.p, self.k, self.q
        if k == 1:
            idx = np.arange(q)
            self.add_table = (idx[:, None] + idx[None, :]) % q
            self.mul_table = (idx[:, None] * idx[None, :]) % q
        else:
            red = _IRREDUCIBLE.get((p, k))
            if red is None:
                red = _find_irreducible(p, k)
            # verify irreducibility via invertibility of all nonzero elements
            add = np.zeros((q, q), dtype=np.int64)
            mul = np.zeros((q, q), dtype=np.int64)
            for a in range(q):
                for b in range(q):
                    # addition: digitwise mod-p
                    s = 0
                    for i in range(k):
                        s += (((a // p**i) + (b // p**i)) % p) * p**i
                    add[a, b] = s
                    mul[a, b] = _poly_mul_mod(a, b, p, k, red)
            self.add_table, self.mul_table = add, mul
            # sanity: every nonzero element invertible
            for a in range(1, q):
                if not (mul[a] == 1).any():
                    raise ValueError(
                        f"reduction poly for GF({p}^{k}) not irreducible")
        # negation and inverse
        self.neg_table = np.array(
            [int(np.where(self.add_table[a] == 0)[0][0]) for a in range(q)])
        inv = np.zeros(q, dtype=np.int64)
        for a in range(1, q):
            inv[a] = int(np.where(self.mul_table[a] == 1)[0][0])
        self.inv_table = inv

    # scalar ops -----------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return int(self.add_table[a, b])

    def sub(self, a: int, b: int) -> int:
        return int(self.add_table[a, self.neg_table[b]])

    def mul(self, a: int, b: int) -> int:
        return int(self.mul_table[a, b])

    def neg(self, a: int) -> int:
        return int(self.neg_table[a])

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("inverse of 0 in GF")
        return int(self.inv_table[a])

    def elements(self) -> range:
        return range(self.q)


@functools.lru_cache(maxsize=None)
def get_field(q: int) -> GF:
    return GF(q)
