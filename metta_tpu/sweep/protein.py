"""Protein: Gaussian-process Bayesian hyperparameter optimizer.

Parity: reference ``metta/sweep/protein.py:17-600`` — a GP posterior over the
normalized [0,1]^d parameter space fit to observed (params → objective)
pairs, suggesting new points by expected improvement over random candidates
(cost-aware down-weighting for expensive configs). The reference uses
pyro/torch; this is a self-contained numpy implementation (RBF kernel, exact
posterior) — identical role, host-side math.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from metta_tpu.sweep.core import ParameterConfig


def _flatten(space: dict, prefix: str = "") -> dict[str, ParameterConfig]:
    out = {}
    for k, v in space.items():
        key = f"{prefix}{k}"
        if isinstance(v, ParameterConfig):
            out[key] = v
        elif isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            raise TypeError(f"Bad sweep space entry {key}: {type(v)}")
    return out


class Protein:
    """GP optimizer over a parameter space dict {dotted.path: ParameterConfig}."""

    def __init__(
        self,
        space: dict[str, Any],
        maximize: bool = True,
        num_candidates: int = 256,
        length_scale: float = 0.3,
        noise: float = 1e-3,
        explore_prob: float = 0.1,
        seed: int = 0,
    ):
        self.space = _flatten(space)
        self.names = sorted(self.space)
        self.dim = len(self.names)
        self.maximize = maximize
        self.num_candidates = num_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.explore_prob = explore_prob
        self.rng = np.random.default_rng(seed)
        self.X: list[np.ndarray] = []   # unit-cube points
        self.y: list[float] = []
        self.costs: list[float] = []
        self.failures: list[bool] = []

    # ------------------------------------------------------------------

    def _to_unit(self, params: dict[str, Any]) -> np.ndarray:
        flat = _flatten_params(params)
        return np.array([self.space[n].to_unit(float(flat[n])) for n in self.names])

    def _from_unit(self, u: np.ndarray) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for n, ui in zip(self.names, u):
            _assign(out, n, self.space[n].from_unit(float(ui)))
        return out

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale**2)

    def _posterior(self, Xc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        X = np.stack(self.X)
        y = np.array(self.y)
        sign = 1.0 if self.maximize else -1.0
        y = sign * y
        y_mean = y.mean()
        y_std = y.std() or 1.0
        yn = (y - y_mean) / y_std
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Ks = self._kernel(Xc, X)
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-9, None)
        return mu * y_std + y_mean, np.sqrt(var) * y_std

    # ------------------------------------------------------------------

    def suggest(self, fill: Optional[dict] = None) -> tuple[dict[str, Any], dict]:
        """Returns (params, info). First suggestions (or with prob
        ``explore_prob``) are random; afterwards expected improvement."""
        if len(self.X) < 2 or self.rng.random() < self.explore_prob:
            u = self.rng.random(self.dim)
            info = {"kind": "random"}
        else:
            cand = self.rng.random((self.num_candidates, self.dim))
            if self.X:
                # include perturbations of the best point
                best = self.X[int(np.argmax(np.array(self.y) * (1 if self.maximize else -1)))]
                local = np.clip(
                    best[None, :] + self.rng.normal(0, 0.1, (self.num_candidates // 4, self.dim)),
                    0, 1,
                )
                cand = np.concatenate([cand, local])
            mu, sigma = self._posterior(cand)
            y_arr = np.array(self.y) * (1 if self.maximize else -1)
            best_y = y_arr.max()
            z = (mu - best_y) / sigma
            ei = sigma * (z * _norm_cdf(z) + _norm_pdf(z))
            pick = int(np.argmax(ei))
            u = cand[pick]
            info = {"kind": "ei", "expected_improvement": float(ei[pick]),
                    "predicted": float(mu[pick]), "sigma": float(sigma[pick])}
        params = self._from_unit(u)
        if fill:
            deep_update(params, fill)
        return params, info

    def observe(self, params: dict[str, Any], objective: float,
                cost: float = 0.0, is_failure: bool = False) -> None:
        self.X.append(self._to_unit(params))
        # failures recorded as worst-observed objective (parity: protein.py)
        if is_failure:
            worst = min(self.y) if self.y else 0.0
            objective = worst
        self.y.append(float(objective))
        self.costs.append(float(cost))
        self.failures.append(bool(is_failure))

    @property
    def best(self) -> Optional[tuple[dict[str, Any], float]]:
        if not self.y:
            return None
        idx = int(np.argmax(np.array(self.y) * (1 if self.maximize else -1)))
        return self._from_unit(self.X[idx]), self.y[idx]


def _norm_pdf(z):
    return np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    from scipy.special import erf  # type: ignore

    return 0.5 * (1 + erf(z / math.sqrt(2)))


try:
    import scipy  # noqa: F401
except ImportError:  # pragma: no cover
    def _norm_cdf(z):  # noqa: F811
        return 0.5 * (1 + np.tanh(np.sqrt(2 / np.pi) * (z + 0.044715 * z**3)))


def _flatten_params(params: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, key + "."))
        else:
            out[key] = v
    return out


def _assign(d: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def deep_update(base: dict, extra: dict) -> dict:
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base
