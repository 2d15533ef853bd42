"""CFAR threshold-factor (tau) computation for white-Gaussian-noise cells.

Host-side config math (runs once per detector configuration). A copy of
``sonar_slam_tpu/kernels/cfar_factors.py`` that imports no JAX. Mirrors the
capability of bruce_slam's ``CFAR.py:71-121`` (jake3991/sonar-SLAM), which
solves the standard radar-detection Pfa equations for the scale factor tau
given (Ntc, Ngc, Pfa, rank). The formulas are the classical CA/SOCA/GOCA/OS
CFAR false-alarm expressions for exponentially distributed square-law cells
(see e.g. Richards, "Fundamentals of Radar Signal Processing", ch. 16).

We solve the monotone-in-tau equations by guarded bisection instead of the
reference's scipy ``root`` multi-start, which is simpler and deterministic.
"""

from __future__ import annotations

import math


def threshold_factor_ca(ntc: int, pfa: float) -> float:
    """Closed-form CA-CFAR factor: Pfa = (1 + tau/N)^-N with N = Ntc."""
    return ntc * (pfa ** (-1.0 / ntc) - 1.0)


def _pfa_half_window_min(x: float, ntc: int) -> float:
    """P(false alarm | one half-window of n = Ntc/2 cells, SO/GO core term).

    The standard smallest-of core sum:
        S(x) = (2 + x/n)^-n * sum_{k=0}^{n-1} C(n-1+k, k) (2 + x/n)^-k
    """
    n = ntc / 2.0
    total = 0.0
    base = 2.0 + x / n
    for k in range(int(n)):
        logc = (
            math.lgamma(n + k) - math.lgamma(k + 1) - math.lgamma(n)
        )
        total += math.exp(logc) * base ** (-k)
    return total * base ** (-n)


def _pfa_soca(x: float, ntc: int) -> float:
    """SOCA-CFAR Pfa(x) (per side; total Pfa = 2 * this)."""
    return 2.0 * _pfa_half_window_min(x, ntc)


def _pfa_goca(x: float, ntc: int) -> float:
    """GOCA-CFAR Pfa(x)."""
    n = ntc / 2.0
    return 2.0 * ((1.0 + x / n) ** (-n) - _pfa_half_window_min(x, ntc))


def _pfa_os(x: float, ntc: int, rank: int) -> float:
    """OS-CFAR Pfa(x) for the rank-th smallest (1-indexed) of Ntc cells.

    Pfa = N! / (N - k)! * Gamma(x + N - k + 1) / Gamma(x + N + 1).

    Parity note: the reference solves this same expression
    (`CFAR.py:116-121`) but its detector then thresholds against the
    0-indexed ``train[rank]`` — i.e. the (rank+1)-th smallest
    (`cfar.cpp:91-92`) — a conservative off-by-one we reproduce verbatim
    in :mod:`sonar_slam_tpu.kernels.cfar`.
    """
    return math.exp(
        math.lgamma(ntc + 1)
        - math.lgamma(ntc - rank + 1)
        + math.lgamma(x + ntc - rank + 1)
        - math.lgamma(x + ntc + 1)
    )


def _bisect_monotone(fn, target: float, lo: float = 1e-8, hi: float = 1e6,
                     tol: float = 1e-12, max_iter: int = 200) -> float:
    """Solve fn(x) = target for fn monotone decreasing in x."""
    flo, fhi = fn(lo), fn(hi)
    if not (fhi <= target <= flo):
        raise ValueError(
            f"target {target} outside bracket [{fhi}, {flo}] — bad CFAR config"
        )
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if fn(mid) > target:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


def threshold_factor_soca(ntc: int, pfa: float) -> float:
    return _bisect_monotone(lambda x: _pfa_soca(x, ntc), pfa)


def threshold_factor_goca(ntc: int, pfa: float) -> float:
    return _bisect_monotone(lambda x: _pfa_goca(x, ntc), pfa)


def threshold_factor_os(ntc: int, rank: int, pfa: float) -> float:
    return _bisect_monotone(lambda x: _pfa_os(x, ntc, rank), pfa)
