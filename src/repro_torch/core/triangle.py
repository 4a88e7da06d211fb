"""Triangle block partitions of the strict lower triangle (paper §VI).

Port of :mod:`repro.core.triangle` (numpy only; the diagonal matching
is the port's own Hopcroft–Karp, not networkx).

A *triangle block partition* of ``{(i,j) : 0 <= j < i < n}`` is a family of
index sets ``R_k ⊂ {0..n-1}`` such that every unordered pair {i,j} lies in
exactly one ``TB(R_k) = {(i,j) : i,j ∈ R_k, i > j}`` — equivalently a clique
partition of K_n / a Steiner (n, r, 2) system when all |R_k| = r.

Constructions implemented (all validated by :func:`validate_partition`):

* ``affine_partition(c, alpha)``   — lines of 𝔸^α(𝔽_c): n = c^α, r = c,
  number of blocks c^(α-1)·(c^α−1)/(c−1).  α=2 is the paper's affine plane
  (c²+c blocks).
* ``projective_partition(c, alpha)`` — lines of ℙ^α(𝔽_c):
  n = (c^(α+1)−1)/(c−1), r = c+1.  α=2 gives the minimal clique partition of
  K_{c²+c+1} with c²+c+1 blocks (de Bruijn–Erdős / Wallis).
* ``cyclic_partition(c, k)``       — the cyclic (c,k)-indexing family of
  Beaumont et al.: n = c·k, cross blocks of size k (one element per group,
  arithmetic progressions of slope s) plus k contiguous diagonal blocks of
  size c.  Valid iff every integer in 1..k-1 is invertible mod c.

Diagonal assignment (paper §VI-C): a perfect matching diagonal-index →
triangle-block with x ∈ R_k, guaranteed to exist by Hall's theorem (Thm 16),
found here with a simple augmenting-path bipartite matching.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .gf import get_field, prime_power


# --------------------------------------------------------------------------
# partition container
# --------------------------------------------------------------------------
@dataclass
class TrianglePartition:
    """A triangle block partition of the strict lower triangle of an n×n
    symmetric matrix, plus the induced diagonal assignment and Q-sets."""

    n: int
    blocks: List[List[int]]                 # R_k, sorted index lists
    construction: str = "unknown"
    n_real: int = -1                        # indices >= n_real are padding
    diag: List[List[int]] = field(default_factory=list)  # D_k lists

    def __post_init__(self):
        if self.n_real < 0:
            self.n_real = self.n
        if not self.diag:
            self.diag = assign_diagonals(self.n, self.blocks,
                                         n_real=self.n_real)

    # ---- derived structure -------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def r(self) -> int:
        return len(self.blocks[0])

    def q_sets(self) -> List[List[int]]:
        """Q_i = blocks whose R_k contains index i (paper §VI-D)."""
        q: List[List[int]] = [[] for _ in range(self.n)]
        for k, R in enumerate(self.blocks):
            for i in R:
                q[i].append(k)
        return q

    def owner_of_pair(self) -> np.ndarray:
        """(n, n) array: owner block of strict-lower pair (i, j), -1 elsewhere."""
        owner = -np.ones((self.n, self.n), dtype=np.int64)
        for k, R in enumerate(self.blocks):
            for a in range(len(R)):
                for b in range(a):
                    i, j = R[a], R[b]
                    if i < j:
                        i, j = j, i
                    owner[i, j] = k
        return owner

    def pair_table(self) -> Dict[Tuple[int, int], int]:
        """{(i, j) i>j -> block k}."""
        out: Dict[Tuple[int, int], int] = {}
        for k, R in enumerate(self.blocks):
            for a in range(len(R)):
                for b in range(a):
                    i, j = max(R[a], R[b]), min(R[a], R[b])
                    out[(i, j)] = k
        return out

    def intersection_table(self) -> np.ndarray:
        """(K, K) array: the unique shared index of blocks k, k' (lines meet
        in at most one point), or -1 if disjoint/parallel.  Diagonal = -1."""
        K = self.num_blocks
        table = -np.ones((K, K), dtype=np.int64)
        membership = [set(R) for R in self.blocks]
        for a in range(K):
            for b in range(K):
                if a == b:
                    continue
                inter = membership[a] & membership[b]
                assert len(inter) <= 1, (
                    f"blocks {a},{b} share {len(inter)} indices — not a "
                    "linear-space partition")
                if inter:
                    table[a, b] = next(iter(inter))
        return table


def validate_partition(n: int, blocks: Sequence[Sequence[int]],
                       n_real: Optional[int] = None) -> None:
    """Raise AssertionError unless ``blocks`` triangle-block-partitions n.

    With ``n_real < n`` the family may reference padded indices in
    ``[n_real, n)`` (paper §VII-C: zero padding); only pairs of *real*
    indices must be covered exactly once, and no pair may be covered twice.
    """
    if n_real is None:
        n_real = n
    seen = np.zeros((n, n), dtype=bool)
    for R in blocks:
        assert len(set(R)) == len(R), f"duplicate index in block {R}"
        for x in R:
            assert 0 <= x < n, f"index {x} out of range in block {R}"
        for a in range(len(R)):
            for b in range(a):
                i, j = max(R[a], R[b]), min(R[a], R[b])
                assert not seen[i, j], f"pair ({i},{j}) covered twice"
                seen[i, j] = True
    for i in range(n_real):
        for j in range(i):
            assert seen[i, j], f"pair ({i},{j}) uncovered"


# --------------------------------------------------------------------------
# diagonal assignment via Hall matching (paper §VI-C, Thm 16)
# --------------------------------------------------------------------------
def hopcroft_karp(n_left: int, n_right: int,
                  adj: Sequence[Sequence[int]]) -> List[int]:
    """Maximum bipartite matching (Hopcroft–Karp) of left vertices
    0..n_left-1 to right vertices 0..n_right-1 along ``adj[x]``.
    Returns ``match[x]``: the right vertex matched to x, or -1.

    Deterministic: vertices and edges are visited in index order.  The
    reference calls networkx here, whose visiting order follows Python's
    set order; any maximum matching satisfies Hall's bound, so the
    spread, and every counter built on the assignment, is the same."""
    INF = float("inf")
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    dist = [0.0] * (n_left + 1)          # dist[n_left]: the free side

    def bfs() -> bool:
        queue: List[int] = []
        for v in range(n_left):
            if match_l[v] < 0:
                dist[v] = 0
                queue.append(v)
            else:
                dist[v] = INF
        dist[n_left] = INF
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            if dist[v] < dist[n_left]:
                for u in adj[v]:
                    w = match_r[u] if match_r[u] >= 0 else n_left
                    if dist[w] == INF:
                        dist[w] = dist[v] + 1
                        if w != n_left:
                            queue.append(w)
        return dist[n_left] != INF

    def dfs(v: int) -> bool:
        # iterative augmenting-path search along the BFS layers
        stack = [(v, iter(adj[v]))]
        path: List[Tuple[int, int]] = []
        while stack:
            x, it = stack[-1]
            advanced = False
            for u in it:
                w = match_r[u]
                if w < 0:
                    if dist[n_left] == dist[x] + 1:
                        path.append((x, u))
                        for xx, uu in path:
                            match_l[xx] = uu
                            match_r[uu] = xx
                        return True
                elif dist[w] == dist[x] + 1:
                    path.append((x, u))
                    stack.append((w, iter(adj[w])))
                    advanced = True
                    break
            if not advanced:
                dist[x] = INF
                stack.pop()
                if path:
                    path.pop()
        return False

    while bfs():
        for v in range(n_left):
            if match_l[v] < 0:
                dfs(v)
    return match_l


def assign_diagonals(n: int, blocks: Sequence[Sequence[int]],
                     n_real: Optional[int] = None) -> List[List[int]]:
    """Assign each diagonal index x ∈ {0..n-1} to exactly one block k with
    x ∈ R_k.  A spread assignment (≤1 per block) exists for Steiner systems
    by Hall's theorem (paper Thm 16); we find a maximum matching via
    Hopcroft–Karp (:func:`hopcroft_karp`) and overflow the remainder
    greedily onto the least-loaded containing block (needed when K < n, e.g. the trivial partition).
    Padded diagonal indices (x ≥ n_real) are skipped — they carry no data."""
    if n_real is None:
        n_real = n
    K = len(blocks)
    adj: List[List[int]] = [[] for _ in range(n)]   # diag index -> candidate blocks
    for k, R in enumerate(blocks):
        for x in R:
            adj[x].append(k)
    match = hopcroft_karp(n_real, K, adj)
    diag: List[List[int]] = [[] for _ in range(K)]
    unmatched: List[int] = []
    for x in range(n_real):
        mk = match[x]
        if mk >= 0:
            diag[mk].append(x)
        else:
            unmatched.append(x)
    for x in unmatched:
        if not adj[x]:
            raise RuntimeError(f"diagonal {x} appears in no block")
        k = min(adj[x], key=lambda kk: len(diag[kk]))
        diag[k].append(x)
    return diag


# --------------------------------------------------------------------------
# constructions
# --------------------------------------------------------------------------
def affine_partition(c: int, alpha: int = 2) -> TrianglePartition:
    """Lines of the affine space 𝔸^α(𝔽_c) — Steiner (c^α, c, 2) system.

    Points are tuples in 𝔽_c^α, encoded as integers base-c.  Lines are
    {p + t·d : t ∈ 𝔽_c} for direction representatives d (one per projective
    equivalence class: last nonzero coordinate normalized to 1)."""
    if alpha < 2:
        raise ValueError("alpha >= 2")
    F = get_field(c)
    n = c**alpha

    def enc(pt: Tuple[int, ...]) -> int:
        v = 0
        for x in reversed(pt):
            v = v * c + x
        return v

    # direction representatives: points of P^{alpha-1}(F_c), normalized form
    dirs: List[Tuple[int, ...]] = []
    for code in range(c**alpha):
        d = tuple((code // c**i) % c for i in range(alpha))
        if all(x == 0 for x in d):
            continue
        # normalized: last nonzero coordinate == 1
        last_nz = max(i for i, x in enumerate(d) if x != 0)
        if d[last_nz] != 1:
            continue
        dirs.append(d)
    assert len(dirs) == (c**alpha - 1) // (c - 1)

    blocks: List[List[int]] = []
    seen_lines = set()
    for d in dirs:
        for code in range(n):
            p = tuple((code // c**i) % c for i in range(alpha))
            line = []
            for t in F.elements():
                q = tuple(F.add(p[i], F.mul(t, d[i])) for i in range(alpha))
                line.append(enc(q))
            key = tuple(sorted(line))
            if key in seen_lines:
                continue
            seen_lines.add(key)
            blocks.append(sorted(line))
    part = TrianglePartition(n=n, blocks=blocks, construction=f"affine(c={c},a={alpha})")
    return part


def projective_partition(c: int, alpha: int = 2) -> TrianglePartition:
    """Lines of ℙ^α(𝔽_c) — Steiner ((c^(α+1)−1)/(c−1), c+1, 2) system.

    Points are normalized homogeneous coords (last nonzero = 1) in
    𝔽_c^(α+1); lines are spans of two distinct points."""
    F = get_field(c)
    dim = alpha + 1

    def normalize(v: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        nz = [i for i, x in enumerate(v) if x != 0]
        if not nz:
            return None
        s = F.inv(v[nz[-1]])
        return tuple(F.mul(s, x) for x in v)

    # enumerate points
    pts: List[Tuple[int, ...]] = []
    index_of: Dict[Tuple[int, ...], int] = {}
    for code in range(c**dim):
        v = tuple((code // c**i) % c for i in range(dim))
        nv = normalize(v)
        if nv is not None and nv not in index_of and nv == v:
            index_of[nv] = len(pts)
            pts.append(nv)
    n = len(pts)
    assert n == (c**dim - 1) // (c - 1)

    blocks: List[List[int]] = []
    seen = set()
    for a in range(n):
        for b in range(a + 1, n):
            u, w = pts[a], pts[b]
            line_pts = set()
            for s in F.elements():
                for t in F.elements():
                    if s == 0 and t == 0:
                        continue
                    v = tuple(F.add(F.mul(s, u[i]), F.mul(t, w[i]))
                              for i in range(dim))
                    nv = normalize(v)
                    if nv is not None:
                        line_pts.add(index_of[nv])
            key = tuple(sorted(line_pts))
            if key not in seen:
                seen.add(key)
                assert len(key) == c + 1
                blocks.append(list(key))
    return TrianglePartition(n=n, blocks=blocks,
                             construction=f"projective(c={c},a={alpha})")


def cyclic_partition(c: int, k: int) -> TrianglePartition:
    """Cyclic (c,k)-indexing family (Beaumont et al., paper §VI): n = c·k.

    Index i ↦ (group g = i // c, residue r = i mod c).  Blocks:
      * cross blocks B_{s,b} = { g·c + ((b + s·g) mod c) : g ∈ [k] } of size k
        for slope s, intercept b ∈ [c];
      * k diagonal blocks {g·c .. g·c+c-1} of size c.
    Pairs across groups (g1,r1),(g2,r2) are covered by the unique slope
    s = (r1−r2)/(g1−g2) mod c, which requires every 1..k-1 invertible mod c
    (i.e. smallest prime factor of c ≥ k)."""
    for d in range(1, k):
        if math.gcd(d, c) != 1:
            raise ValueError(
                f"cyclic (c={c},k={k}) invalid: gcd({d},{c}) != 1")
    n = c * k
    blocks: List[List[int]] = []
    for s in range(c):
        for b in range(c):
            blocks.append(sorted(g * c + (b + s * g) % c for g in range(k)))
    for g in range(k):
        blocks.append(list(range(g * c, (g + 1) * c)))
    return TrianglePartition(n=n, blocks=blocks,
                             construction=f"cyclic(c={c},k={k})")


def trivial_partition(n: int) -> TrianglePartition:
    """The one-block partition (whole lower triangle)."""
    return TrianglePartition(n=n, blocks=[list(range(n))],
                             construction="trivial")


def refined_cyclic_partition(c: int, k: int, M: int, m: int
                             ) -> TrianglePartition:
    """Cyclic (c,k) family whose size-c diagonal groups are recursively
    partitioned (they would otherwise overflow fast memory when c ≫ k).

    The cross blocks of two different slopes share at most one index (proof:
    shared indices in groups g₁≠g₂ would cover a cross-group pair twice,
    contradicting validity), so the refined family is still a valid pair
    cover; sub-partition padding uses *virtual* indices ≥ c·k that carry no
    data (validated with ``n_real``)."""
    for d in range(1, k):
        if math.gcd(d, c) != 1:
            raise ValueError(f"cyclic (c={c},k={k}) invalid")
    n_hat = c * k
    blocks: List[List[int]] = []
    for s in range(c):
        for b in range(c):
            blocks.append(sorted(g * c + (b + s * g) % c for g in range(k)))
    sub = optimal_partition(c, M, m)          # recursive refinement
    virt = n_hat
    for g in range(k):
        remap: Dict[int, int] = {}
        for local in range(sub.n):
            if local < c:
                remap[local] = g * c + local
            else:
                remap[local] = virt + (local - c)
        virt += max(sub.n - c, 0)
        for R in sub.blocks:
            blocks.append(sorted(remap[x] for x in R))
    return TrianglePartition(
        n=virt, blocks=blocks, n_real=n_hat,
        construction=f"cyclic(c={c},k={k})+[{sub.construction}]")


# --------------------------------------------------------------------------
# construction selection + padding (paper §VII-C)
# --------------------------------------------------------------------------
def steiner_divisibility(n: int, r: int) -> bool:
    """Necessary divisibility conditions of Wilson's theorem (paper Thm 14)."""
    return (n - 1) % (r - 1) == 0 and (n * (n - 1)) % (r * (r - 1)) == 0


def find_partition(n: int, r: int, max_block: Optional[int] = None
                   ) -> Optional[TrianglePartition]:
    """Return a triangle partition of exactly n with block size r, if one of
    our constructions yields it.  ``max_block`` caps the largest block size
    (cyclic constructions have diagonal blocks of size c = n/r > r)."""
    if r >= n:
        return trivial_partition(n) if n >= 1 else None
    # affine spaces: n = c^alpha, r = c
    pk = prime_power(r)
    if pk is not None:
        alpha = 2
        while r**alpha <= n:
            if r**alpha == n:
                return affine_partition(r, alpha)
            alpha += 1
    # projective: n = (c^(alpha+1)-1)/(c-1), r = c+1
    pk = prime_power(r - 1)
    if pk is not None and r >= 3:
        c = r - 1
        alpha = 2
        while True:
            npts = (c**(alpha + 1) - 1) // (c - 1)
            if npts == n:
                return projective_partition(c, alpha)
            if npts > n:
                break
            alpha += 1
    # cyclic: n = c*k with k = r (cross blocks size k=r) and diag blocks size c.
    # Balanced only when c == r; allow c >= r with unequal diag blocks? Keep
    # strict: require c == r for balance -> n == r*r, smallest prime factor of
    # r >= r means r prime... too restrictive; instead use k=r, c=n//r when
    # valid and c == r (affine already covers c prime-power). Use cyclic when
    # n == c*r, blocks of size r, spf(c) >= r:
    if n % r == 0:
        c = n // r
        if (all(math.gcd(d, c) == 1 for d in range(1, r)) and c >= r
                and (max_block is None or c <= max_block)):
            # note: diagonal blocks have size c (>= r); acceptable for
            # sequential use only if c*(c-1)/2 fits memory—caller decides
            # via max_block.
            return cyclic_partition(c, r)
    return None


def padded_partition(n1: int, r: int, max_pad: Optional[int] = None,
                     max_block: Optional[int] = None) -> TrianglePartition:
    """Smallest n̂₁ ≥ n1 with a constructible (n̂₁, r, 2) partition; the
    matrices are zero-padded to n̂₁ (paper §VII-C guarantees n̂₁ < n1 + r²
    under Wilson's theorem; our constructive search may pad slightly more but
    is bounded by the affine grid: n̂₁ ≤ c^⌈log_c n1⌉ for c = r)."""
    if max_pad is None:
        max_pad = max(4 * r * r, 64)
    for n in range(n1, n1 + max_pad + 1):
        part = find_partition(n, r, max_block=max_block)
        if part is not None:
            return part
    # fall back: affine with alpha big enough (n = r^alpha >= n1)
    pk = prime_power(r)
    if pk is not None:
        alpha = 2
        while r**alpha < n1:
            alpha += 1
        return affine_partition(r, alpha)
    raise ValueError(f"no triangle partition found for n1={n1}, r={r}")


def _best_spec(n1: int, M: int, m: int, depth: int = 0):
    """Recursive construction search: returns (score, kind, params) where
    ``score`` is the per-real-index block-membership count — panel reads are
    n₂·m·n1·score, so minimizing score minimizes leading-order reads.

    Ideal Steiner (n̂, r, 2) score is (n̂−1)/(r−1); with r ≈ √(2M) from the
    memory bound (eq. 2) and the Fisher-type constraint n̂ ≥ r(r−1)+1, pure
    affine/projective families only reach r ≈ √n̂.  The cyclic (c,k) family
    decouples them (score ≈ c + subscore(c)), with recursively refined
    diagonal groups."""
    if M >= n1 * (n1 + 1) // 2 + m * n1:
        return (1.0, "trivial", (n1,))
    r_max = best_r_for_memory(M, m)
    if r_max >= n1:
        return (1.0, "trivial", (n1,))
    best = None

    def consider(score, kind, params):
        nonlocal best
        if best is None or score < best[0]:
            best = (score, kind, params)

    for c in range(2, r_max + 1):
        if prime_power(c) is None:
            continue
        alpha = 2
        while c**alpha < n1:
            alpha += 1
        if alpha <= 6:
            consider((c**alpha - 1) / (c - 1), "affine", (c, alpha))
        if c + 1 <= r_max:
            alpha = 2
            while (c**(alpha + 1) - 1) // (c - 1) < n1:
                alpha += 1
            npts = (c**(alpha + 1) - 1) // (c - 1)
            consider((npts - 1) / c, "projective", (c, alpha))
    if depth < 3:
        for k in range(2, r_max + 1):
            c0 = max(k, -(-n1 // k))
            found = None
            for c in range(c0, c0 + 6 * k + 8):
                if all(math.gcd(d, c) == 1 for d in range(1, k)):
                    found = c
                    break
            if found is None:
                continue
            c = found
            if c * k < n1:
                continue
            if c * (c - 1) // 2 + 1 + m * c <= M:
                # diagonal group fits as a single block
                consider(float(c + 1), "cyclic", (c, k))
            else:
                sub_score, _, _ = _best_spec(c, M, m, depth + 1)
                consider(c + sub_score, "refined_cyclic", (c, k))
    if best is None:
        best = ((n1 - 1) / (r_max - 1) * 2, "padded", (n1, r_max))
    return best


def optimal_partition(n1: int, M: int, m: int) -> TrianglePartition:
    """Pick the construction minimizing leading-order sequential reads under
    the memory constraint r(r−1)/2 + 1 + m·r ≤ M (paper eq. (2)); resolves
    the padding-vs-block-size tradeoff of §VII-C automatically."""
    score, kind, params = _best_spec(n1, M, m)
    if kind == "trivial":
        return trivial_partition(n1)
    if kind == "affine":
        return affine_partition(*params)
    if kind == "projective":
        return projective_partition(*params)
    if kind == "cyclic":
        return cyclic_partition(*params)
    if kind == "refined_cyclic":
        c, k = params
        return refined_cyclic_partition(c, k, M, m)
    return padded_partition(n1, best_r_for_memory(M, m),
                            max_block=best_r_for_memory(M, m))


def best_r_for_memory(M: int, m: int) -> int:
    """Paper eq. (2): r = ⌊sqrt(2M + m²) − m⌋ — the largest block size whose
    triangle block plus m column panels fit in fast memory M."""
    r = int(math.isqrt(2 * M + m * m)) - m
    return max(r, 2)
