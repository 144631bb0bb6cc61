"""Theorem 1 / Proposition 1 / Theorem 2 / Theorem 3 calculators.

Counterpart of ``repro/core/theory.py``, copied as it is (pure math on
Python floats: nothing of it touches a tensor).

These implement the paper's bound *formulas* so experiments can (a) verify
Proposition 1's ordering Gamma > Theta > Lambda under condition (26),
(b) evaluate the Theorem-1 divergence bound on measured deltas, and
(c) plot the convergence-rate terms of Theorems 2/3 against the sweeps in
Figs. 3-5.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class BoundParams:
    """Problem constants of Assumptions 1-3 + Adam hyperparameters."""
    d: int                    # model dimension
    G: float                  # gradient bound (Assumption 2)
    rho: float                # Lipschitz constant (Assumption 1)
    sigma_l: float            # local variance (Assumption 3)
    sigma_g: float            # global variance (Assumption 3)
    eta: float                # learning rate
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    D_n: float = 1.0          # local batch size |D~_n|


def phi(p: BoundParams) -> float:
    """Eq. (21)."""
    return p.beta1 / math.sqrt(p.beta2)


def psi(p: BoundParams) -> float:
    """Eq. (22)."""
    return 1.0 + p.beta1 / math.sqrt(p.beta2) + \
        (p.eta * p.rho * (1 - p.beta1) / math.sqrt(p.eps)) * \
        (1 + (1 - p.beta2) * p.d * p.G ** 2 / p.eps)


def chi(p: BoundParams) -> float:
    """Eq. (23)."""
    t1 = p.d * p.G * p.eta * (
        (2 * p.beta1 * (1 - math.sqrt(p.beta2))
         / (p.eps * math.sqrt(p.eps * p.beta2))) * (p.G ** 2 + p.eps)
        + ((1 - p.beta1) * p.beta2 / (p.eps * math.sqrt(p.eps))) * p.G ** 2)
    t2 = ((1 - p.beta1) * p.eta *
          (p.sigma_l / math.sqrt(p.D_n) + p.sigma_g) / math.sqrt(p.eps)) * \
        (1 + (1 - p.beta2) * p.d * p.G ** 2 / p.eps)
    return t1 + t2


def _roots(p: BoundParams):
    """The two roots (psi +- sqrt(psi^2 + 4 phi)) / 2 of the recurrence."""
    ps, ph = psi(p), phi(p)
    disc = math.sqrt(ps ** 2 + 4 * ph)
    return (ps - disc) / 2.0, (ps + disc) / 2.0, disc


def gamma(p: BoundParams, l: int) -> float:
    """Eq. (17) — weight of ||dW|| in the divergence bound."""
    r_minus, r_plus, disc = _roots(p)
    ph = phi(p)
    c = p.d * p.G ** 2 * p.eta * p.rho / (p.eps * math.sqrt(p.eps)) \
        * p.beta1 * (1 - p.beta2)
    term1 = (r_minus ** l) * (ph + (disc - psi(p)) / 2.0 - c)
    term2 = ((disc + psi(p)) / 2.0 - ph + c) * (r_plus ** l)
    return (term1 + term2) / disc


def lam(p: BoundParams, l: int) -> float:
    """Eq. (18) — weight of ||dM||."""
    r_minus, r_plus, disc = _roots(p)
    return (p.eta * p.beta1 / (math.sqrt(p.eps) * disc)) * \
        (r_plus ** l - r_minus ** l)


def theta(p: BoundParams, l: int) -> float:
    """Eq. (19) — weight of ||dV||."""
    r_minus, r_plus, disc = _roots(p)
    return (math.sqrt(p.d) * p.G * p.eta * p.beta2
            / (2 * p.eps * math.sqrt(p.eps) * disc)) * \
        (r_plus ** l - r_minus ** l)


def phi_const(p: BoundParams, l: int) -> float:
    """Eq. (20) — data-heterogeneity floor of the divergence bound."""
    r_minus, r_plus, disc = _roots(p)
    ps, ph = psi(p), phi(p)
    sig = p.sigma_l / math.sqrt(p.D_n) + p.sigma_g
    head = (sig / disc) * (
        (p.eta / math.sqrt(p.eps)) * (1 - p.beta1)
        + (p.d * p.G ** 2 * p.eta / (p.eps * math.sqrt(p.eps))) * (1 - p.beta2)
    ) * (r_plus ** l - r_minus ** l)
    tail = (chi(p) / (1 - ps - ph)) * (
        (1.0 / disc) * ((1 - r_plus) * (r_minus ** l)
                        - (1 - r_minus) * (r_plus ** l)) + 1.0)
    return head + tail


def proposition1_condition(p: BoundParams) -> bool:
    """Eq. (26): beta2 < 1 - 1/(1 + 2 G rho sqrt(d))."""
    return p.beta2 < 1.0 - 1.0 / (1.0 + 2 * p.G * p.rho * math.sqrt(p.d))


def proposition1_holds(p: BoundParams, l: int) -> bool:
    """Gamma > Theta > Lambda (Eq. 27)."""
    return gamma(p, l) > theta(p, l) > lam(p, l)


def divergence_bound(p: BoundParams, l: int, err_w: float, err_m: float,
                     err_v: float) -> float:
    """Theorem 1 (Eq. 16): Gamma*err_w + Lambda*err_m + Theta*err_v + Phi,
    with err_* = FedAvg-weighted sparsification error norms
    ||(1 - mask) . delta||."""
    return gamma(p, l) * err_w + lam(p, l) * err_m + \
        theta(p, l) * err_v + phi_const(p, l)


# ---------------------------------------------------------------------------
# Convergence-rate bounds
# ---------------------------------------------------------------------------


def theorem2_bound(p: BoundParams, alpha: float, L: int, T: int,
                   f0_minus_fT: float) -> float:
    """Non-convex rate bound (Eq. 29), as a function of the sparsification
    ratio alpha, local epochs L and rounds T."""
    e = p.eps
    t1 = 2.0 / (p.eta * T) * f0_minus_fT
    t2 = 2.0 * ((p.eta * p.rho + 2) * (1 - alpha) + p.eta * p.rho - 1) * \
        (p.eta * p.G ** 2 * p.d * L ** 2 / e)
    geom2 = p.beta2 * (1 - p.beta2 ** L) / (1 - p.beta2)
    geom1 = 4 * p.beta1 * (1 - p.beta1 ** L) / (e * (1 - p.beta1) ** 2)
    t3 = 6 * p.G ** 2 * p.d * (
        (L - geom2) * (p.G ** 4 * p.d * L / (4 * e ** 3))
        + L ** 2 / e + geom1 + 1 + p.rho ** 2 * L ** 2 / (3 * e))
    sig = (p.sigma_l / math.sqrt(p.D_n) + p.sigma_g) ** 2
    t4 = 6 * sig
    return t1 + t2 + t3 + t4


def theorem3_bound(p: BoundParams, alpha: float, L: int, T: int,
                   mu: float, f0_minus_fstar: float) -> float:
    """PL-condition rate bound (Eq. 31)."""
    e = p.eps
    t1 = (1 - p.eta * mu) ** T * f0_minus_fstar
    t2 = (p.eta * p.G ** 2 * p.d * L ** 2 / (mu * e)) * \
        ((p.eta * p.rho + 2) * (1 - alpha) + p.eta * p.rho - 1)
    geom1 = 4 * p.beta1 * (1 - p.beta1 ** L) / (e * (1 - p.beta1) ** 2)
    geom2 = p.beta2 * (1 - p.beta2 ** L) / (1 - p.beta2)
    t3 = (3 * p.G ** 2 * p.d / mu) * (
        geom1 + L ** 2 / e + p.rho ** 2 * L ** 2 / (3 * e) + 1
        + (p.G ** 4 * p.d * L / (4 * e ** 3)) * (L - geom2))
    sig = (p.sigma_l / math.sqrt(p.D_n) + p.sigma_g) ** 2
    t4 = 3 * sig / mu
    return t1 + t2 + t3 + t4


def optimal_local_epochs(p: BoundParams, alpha: float, T: int,
                         f0_minus_fT: float) -> float:
    """Remark 6 crossover: L* = ((1-alpha) rho G^2 d /
    (eps (F0-FT) sqrt(T)))^(1/4)."""
    return ((1 - alpha) * p.rho * p.G ** 2 * p.d /
            (p.eps * max(1e-12, f0_minus_fT) * math.sqrt(T))) ** 0.25
