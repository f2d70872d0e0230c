"""Closed-form error bounds from the paper (Lemmas 3-4, Theorems 1-2, eq. 43).

A copy of ``repro.core.bounds``. Everything here is plain numpy on
scalars/small arrays — these are analysis formulas plotted against the
empirical benchmarks, not device code.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln


def h_alpha_beta(alpha: float, beta: float) -> float:
    """h(alpha, beta) = (arcsin(alpha) - arcsin(alpha*beta)) / pi (eq. 27)."""
    return (np.arcsin(alpha) - np.arcsin(alpha * beta)) / np.pi


def theorem1_bound(n, d: int, alpha: float, beta: float):
    """Pr(T_hat != T) <= d^3 exp(-n h^2(alpha,beta) / 2) (eq. 23)."""
    n = np.asarray(n, dtype=np.float64)
    return (d ** 3) * np.exp(-0.5 * n * h_alpha_beta(alpha, beta) ** 2)


def crossover_hoeffding(n, theta_e: float, theta_ep: float):
    """Lemma 4: Pr(theta_hat_e <= theta_hat_e') <= exp(-n dtheta^2 / 2)."""
    n = np.asarray(n, dtype=np.float64)
    dt = theta_e - theta_ep
    return np.exp(-0.5 * n * dt * dt)


def shared_node_probs(rho_jk: float, rho_ks: float) -> tuple[float, float, float]:
    """(p0, p1, p2) for pairs e=(j,k), e'=(k,s) sharing node k (eqs. 18-20)."""
    a_jk = np.arcsin(rho_jk)
    a_ks = np.arcsin(rho_ks)
    a_prod = np.arcsin(rho_jk * rho_ks)
    p0 = 0.5 + a_prod / np.pi
    p1 = 0.25 + (-a_jk + a_ks - a_prod) / (2 * np.pi)
    p2 = 0.25 + (a_jk - a_ks - a_prod) / (2 * np.pi)
    return float(p0), float(p1), float(p2)


def crossover_chernoff(n, p0: float, p1: float, p2: float):
    """Lemma 3: Pr(theta_hat_e <= theta_hat_e') <= (p0 + 2 sqrt(p1 p2))^n.

    Exponent E = -ln(p0 + 2 sqrt(p1 p2)) is tight (eq. 15).
    """
    n = np.asarray(n, dtype=np.float64)
    return np.power(p0 + 2.0 * np.sqrt(p1 * p2), n)


def chernoff_exponent(p0: float, p1: float, p2: float) -> float:
    return float(-np.log(p0 + 2.0 * np.sqrt(p1 * p2)))


def crossover_exact(n: int, p0: float, p1: float, p2: float) -> float:
    """Exact Pr(sum_i T_i >= 0), T_i in {0,+1,-1} w.p. (p0,p1,p2) i.i.d.

    Brute-force over multinomial counts (k1 = #+1, k2 = #-1 <= k1), in log
    space for stability — the 'exact error' curve of Figs. 5-6.
    """
    lp = np.log(np.asarray([max(p0, 1e-300), max(p1, 1e-300), max(p2, 1e-300)]))
    total = -np.inf
    lgn = gammaln(n + 1)
    for k1 in range(n + 1):
        k2s = np.arange(0, min(k1, n - k1) + 1)
        k0s = n - k1 - k2s
        terms = (
            lgn
            - gammaln(k1 + 1) - gammaln(k2s + 1) - gammaln(k0s + 1)
            + k0s * lp[0] + k1 * lp[1] + k2s * lp[2]
        )
        m = terms.max()
        total = np.logaddexp(total, m + np.log(np.exp(terms - m).sum()))
    return float(np.exp(total))


def theorem2_bound(d1: float, d2: float) -> float:
    """err_rel <= sqrt(D1) + sqrt(D2) + sqrt(D1 D2) (eq. 36)."""
    return np.sqrt(d1) + np.sqrt(d2) + np.sqrt(d1 * d2)


def persymbol_est_error_bound(rate: int, n: int, rho: float) -> float:
    """eq. (43): err_est <= 2 sqrt(1-sigma_u^2) + (1-sigma_u^2) + sqrt((1+rho^2)/n)."""
    from .quantizers import reconstruction_distortion

    dist = reconstruction_distortion(rate)
    return theorem2_bound(dist, dist) + np.sqrt((1.0 + rho * rho) / n)


def union_bound_recovery(n, thetas_e: np.ndarray, thetas_rival: np.ndarray):
    """Structure-aware union bound (eq. 25) given per-edge strongest-rival
    thetas: sum_e exp(-n (theta_e - theta_e*)^2 / 2)."""
    n = np.asarray(n, dtype=np.float64)[..., None]
    dt = np.asarray(thetas_e) - np.asarray(thetas_rival)
    return np.exp(-0.5 * n * dt * dt).sum(axis=-1)
