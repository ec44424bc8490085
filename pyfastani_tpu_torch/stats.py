"""Statistical kernel of the FastANI method (``skch::Stat`` equivalent).

Reimplements, in pure NumPy float64/float32, the statistics that the
reference obtains from ``map_stats.hpp`` + boost-math binomials (declared at
``pyfastani: include/fastani/map/map_stats.pxd:4-29``; the C++ body is
absent from the reference snapshot, so behavior is reconstructed from the
FastANI publication (Jain et al. 2018) and pinned by the reference golden
test ``recommendedWindowSize(1e-3, 16, 4, 80, 3000, 5_000_000) == 24``
(``pyfastani: src/pyfastani/tests/test_ani.py:60``).

Numeric conventions mirrored from the C++:

* ``j2md`` / ``md2j`` compute in double precision and round the result to
  float32 (the C++ functions return ``float`` but the expressions promote
  to ``double``).
* boost's ``quantile(complement(binomial(n, p), q))`` with the default
  ``integer_round_outwards`` discrete policy returns the smallest integer
  ``m`` with ``P(X > m) <= q``.
* The relaxed-hit confidence interval is 0.9 (``skch::fixed``); this is the
  unique value for which the derived default window size is 24.

On-device use: the two data-dependent decisions of the mapping pipeline --
the L1 minimum-hit count and the L2 identity-gate -- depend only on the
fragment sketch size ``s`` for fixed parameters, so they are precomputed
here as integer lookup tables (`min_hits_relaxed_table`,
`l2_gate_table`) and gathered on device, keeping binomial quantile math off
the device entirely.

A copy of ``pyfastani_tpu/stats.py``, so that the port imports nothing of
the JAX package; the tables equal its bit for bit and share its on-disk
cache (`_default_cache_dir`, ``PYFASTANI_TPU_CACHE_DIR``).
"""

from __future__ import annotations

import functools
import math
import os
import tempfile

import numpy as np

__all__ = [
    "j2md",
    "md2j",
    "md_lower_bound",
    "estimate_minimum_hits",
    "estimate_minimum_hits_relaxed",
    "estimate_pvalue",
    "recommended_window_size",
    "min_hits_relaxed_table",
    "l2_gate_table",
    "CONFIDENCE_INTERVAL",
]

# skch::fixed::confidence_interval -- confidence interval used to relax the
# Jaccard cutoffs in L1/L2.  [reconstructed: 0.9 is the unique value
# reproducing the pinned window size of 24 at default parameters.]
CONFIDENCE_INTERVAL = 0.9


def _default_cache_dir() -> str:
    """The JAX package's cache directory (``utils/jaxconfig.py``): ``.jax_cache``
    at the root of a checkout, else one under the temporary directory."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if os.path.isdir(os.path.join(repo, ".git")) or os.access(repo, os.W_OK):
        return os.path.join(repo, ".jax_cache")
    return os.path.join(tempfile.gettempdir(), "jax_cache_pyfastani_tpu")


def _f32(x: float) -> float:
    """Round a python float through float32, mirroring C++ ``float`` stores."""
    return float(np.float32(x))


def j2md(j: float, k: int) -> float:
    """Jaccard estimate -> Mash distance (``skch::Stat::j2md``)."""
    if j == 0:
        return 1.0
    if j == 1:
        return 0.0
    return _f32((-1.0 / k) * math.log(2.0 * j / (1.0 + j)))


def md2j(d: float, k: int) -> float:
    """Mash distance -> Jaccard estimate (``skch::Stat::md2j``)."""
    return _f32(1.0 / (2.0 * math.exp(k * d) - 1.0))


_LOGFACT = np.zeros(1, dtype=np.float64)  # _LOGFACT[i] = lgamma(i + 1)


def _log_factorials(n: int) -> np.ndarray:
    """lgamma(i + 1) for i = 0..n, cached and grown on demand."""
    global _LOGFACT
    if _LOGFACT.shape[0] <= n:
        old = _LOGFACT.shape[0]
        grown = np.empty(max(n + 1, 2 * old), dtype=np.float64)
        grown[:old] = _LOGFACT
        for i in range(old, grown.shape[0]):
            grown[i] = math.lgamma(i + 1)
        _LOGFACT = grown
    return _LOGFACT


def _binom_cdf_table(n: int, p: float) -> np.ndarray:
    """P(X <= m) for m = 0..n, X ~ Binomial(n, p), exact float64 cumsum."""
    if p <= 0.0:
        return np.ones(n + 1, dtype=np.float64)
    if p >= 1.0:
        out = np.zeros(n + 1, dtype=np.float64)
        out[n] = 1.0
        return out
    lf = _log_factorials(n)
    m = np.arange(n + 1, dtype=np.float64)
    logc = lf[n] - lf[: n + 1] - lf[n::-1]
    logpmf = logc + m * math.log(p) + (n - m) * math.log1p(-p)
    pmf = np.exp(logpmf)
    cdf = np.cumsum(pmf)
    return np.minimum(cdf, 1.0)


@functools.lru_cache(maxsize=4096)
def _binom_quantile_complement(n: int, p: float, q: float) -> int:
    """boost ``quantile(complement(binomial(n, p), q))``.

    Returns the smallest integer ``m`` such that ``P(X > m) <= q`` (boost's
    ``integer_round_outwards`` policy for complemented discrete quantiles).
    """
    if n == 0 or p <= 0.0:
        return 0
    if p >= 1.0:
        return n
    cdf = _binom_cdf_table(n, p)
    # smallest m with cdf[m] >= 1 - q
    target = 1.0 - q
    m = int(np.searchsorted(cdf, target, side="left"))
    return min(m, n)


@functools.lru_cache(maxsize=4096)
def _binom_sf(n: int, p: float, m: int) -> float:
    """P(X > m) for X ~ Binomial(n, p)  (= boost ``cdf(complement(...))``)."""
    if m < 0:
        return 1.0
    if m >= n:
        return 0.0
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    cdf = _binom_cdf_table(n, p)
    return float(max(0.0, 1.0 - cdf[m]))


def md_lower_bound(d: float, s: int, k: int, ci: float) -> float:
    """Lower bound on Mash distance d within confidence interval ``ci``.

    [reconstructed ``skch::Stat::md_lower_bound``] Converts d to a Jaccard
    probability, takes the upper (1 - (1-ci)/2) binomial quantile of the
    shared-sketch count, and maps the optimistic Jaccard back to a distance.
    A *lower* bound on distance is an *upper* bound on identity.
    """
    q2 = (1.0 - ci) / 2.0
    j = md2j(d, k)
    x = _binom_quantile_complement(int(s), float(j), q2)
    jaccard_upper = _f32(x * 1.0 / s)
    return j2md(jaccard_upper, k)


def estimate_minimum_hits(s: int, k: int, perc_identity: float) -> int:
    """Min shared sketches for the desired identity (``estimateMinimumHits``)."""
    mash_dist = _f32(1.0 - perc_identity / 100.0)
    jaccard = md2j(mash_dist, k)
    return int(math.ceil(1.0 * s * jaccard))


def _identity_upper_bound(shared: int, s: int, k: int) -> float:
    """100 * (1 - md_lower_bound(j2md(shared/s))) -- the optimistic identity
    for ``shared`` conserved sketches out of ``s`` under the CI."""
    jaccard = _f32(1.0 * shared / s)
    d = j2md(jaccard, k)
    d_lower = md_lower_bound(d, s, k, CONFIDENCE_INTERVAL)
    return _f32(100.0 * (1.0 - d_lower))


@functools.lru_cache(maxsize=65536)
def estimate_minimum_hits_relaxed(s: int, k: int, perc_identity: float) -> int:
    """Relax `estimate_minimum_hits` down while the CI-optimistic identity of
    the hit count still reaches ``perc_identity``
    ([reconstructed ``skch::Stat::estimateMinimumHitsRelaxed``])."""
    if s <= 0:
        return 0
    minimum = estimate_minimum_hits(s, k, perc_identity)
    relaxed = minimum
    pi32 = np.float32(perc_identity)
    for i in range(minimum, -1, -1):
        if np.float32(_identity_upper_bound(i, s, k)) >= pi32:
            relaxed = i
        else:
            break
    return relaxed


def estimate_pvalue(
    s: int,
    k: int,
    alphabet_size: int,
    identity: float,
    length_query: int,
    length_reference: int,
) -> float:
    """P-value of a random mapping appearing significant
    ([reconstructed ``skch::Stat::estimate_pvalue``], after Mash).

    Scaled by the reference length as a multiple-testing correction; this
    factor is required to reproduce the pinned default window size of 24.
    """
    kmer_space = float(alphabet_size) ** k
    p_x = 1.0 / (1.0 + kmer_space / length_query)
    p_y = 1.0 / (1.0 + kmer_space / length_reference)
    # expected Jaccard of two random sequences of these lengths
    r = p_x * p_y / (p_x + p_y - p_x * p_y)
    x = estimate_minimum_hits_relaxed(s, k, identity)
    # P(shared >= x by chance), corrected over the reference length
    return float(length_reference) * _binom_sf(int(s), float(r), x - 1)


@functools.lru_cache(maxsize=1024)
def recommended_window_size(
    pvalue_cutoff: float,
    k: int,
    alphabet_size: int,
    identity: float,
    length_query: int,
    length_reference: int,
) -> int:
    """Largest winnowing window w whose expected fragment sketch (s = 2L/w)
    still keeps the random-mapping p-value under the cutoff
    ([reconstructed ``skch::Stat::recommendedWindowSize``]; pinned to return
    24 at default parameters by ``test_ani.py:60``)."""
    optimal = 1
    for w in range(1, max(2, length_query)):
        s = int(2.0 * length_query / w)
        if s == 0:
            break
        pv = estimate_pvalue(s, k, alphabet_size, identity, length_query, length_reference)
        if pv <= pvalue_cutoff:
            optimal = w
        else:
            break
    return optimal


# --- Device-side lookup tables ---------------------------------------------


def _table_cache_load(name: str, s_max: int, k: int, perc_identity: float):
    """On-disk cache for the device lookup tables.

    The tables are exact integer functions of (s_max, k, percentage
    identity) but cost seconds of float64 binomial work to derive (the
    gate table alone is ~s_max^2 log s_max CDF evaluations); sessions
    rebuild them per process, so persist like the XLA compile cache.
    Set PYFASTANI_TPU_CACHE_DIR=0 to disable.
    """
    root = os.environ.get("PYFASTANI_TPU_CACHE_DIR", _default_cache_dir())
    if not root or root == "0":
        return None, None
    path = os.path.join(
        root, f"stats_{name}_{s_max}_{k}_{float(perc_identity):.6g}.npy"
    )
    if os.path.exists(path):
        try:
            return np.load(path), path
        except Exception:
            return None, path
    return None, path


def _table_cache_store(path, table):
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}.npy"
        np.save(tmp, table)
        os.replace(tmp, path)
    except Exception:
        pass


@functools.lru_cache(maxsize=64)
def min_hits_relaxed_table(s_max: int, k: int, perc_identity: float) -> np.ndarray:
    """``estimate_minimum_hits_relaxed(s)`` for s = 0..s_max, as int32.

    Gathered per fragment on device: the L1 stage needs the relaxed hit
    count for the fragment's actual sketch size.
    """
    cached, path = _table_cache_load("minhits", s_max, k, perc_identity)
    if cached is not None:
        return cached
    out = np.zeros(s_max + 1, dtype=np.int32)
    for s in range(1, s_max + 1):
        out[s] = estimate_minimum_hits_relaxed(s, k, float(perc_identity))
    _table_cache_store(path, out)
    return out


@functools.lru_cache(maxsize=64)
def identity_table(s_max: int, k: int) -> np.ndarray:
    """``float32 identity(shared, s)`` for s, shared = 0..s_max, as (S+1, S+1).

    ``identity_table[s, shared] = f32(100 * (1 - j2md(shared / s, k)))``
    computed with the exact host float pipeline (float64 log rounded to
    float32), so device engines gathering from this table produce
    bit-identical identities to the host engine -- including the cases
    where two distinct shared counts round to the same float32 identity
    (those are genuine ties in the reference's float sort and must tie on
    device too).
    """
    cached, path = _table_cache_load("ident2d", s_max, k, 0.0)
    if cached is not None:
        return cached
    out = np.zeros((s_max + 1, s_max + 1), dtype=np.float32)
    for s in range(1, s_max + 1):
        for shared in range(0, s + 1):
            # same float pipeline as _engine_np._map_fragment: the jaccard
            # stays float64 into j2md, whose result rounds through float32
            out[s, shared] = np.float32(100.0 * (1.0 - j2md(1.0 * shared / s, k)))
        out[s, s + 1 :] = out[s, s]
    _table_cache_store(path, out)
    return out


@functools.lru_cache(maxsize=64)
def l2_gate_table(s_max: int, k: int, perc_identity: float) -> np.ndarray:
    """Smallest conserved-sketch count whose CI-optimistic identity passes
    ``perc_identity``, for each sketch size s = 0..s_max (int32).

    The reference L2 reports a mapping iff ``nucIdentityUpperBound >=
    percentageIdentity`` ([reconstructed] ``computeMap.hpp::doL2Mapping``);
    for fixed s that is a monotone threshold on the shared count, so the
    whole gate becomes one device gather + compare.
    Entries are ``s_max + 2`` ("impossible") when no count passes.
    """
    cached, path = _table_cache_load("l2gate", s_max, k, perc_identity)
    if cached is not None:
        return cached
    out = np.full(s_max + 1, s_max + 2, dtype=np.int32)
    pi32 = np.float32(perc_identity)
    for s in range(1, s_max + 1):
        # binary search the monotone boundary
        lo, hi = 0, s + 1
        while lo < hi:
            mid = (lo + hi) // 2
            if np.float32(_identity_upper_bound(mid, s, k)) >= pi32:
                hi = mid
            else:
                lo = mid + 1
        if lo <= s:
            out[s] = lo
    _table_cache_store(path, out)
    return out
