"""Search-space primitives, trial configs and the TPE searcher.

Port of the JAX package's ``tune/search.py`` (numpy only), kept as the
port's own copy: the domains (``choice``, ``uniform``, ``loguniform``,
``randint``), ``grid_search``, ``generate_trial_configs`` and
``TPESearcher`` draw from ``numpy.random.Generator`` exactly as there,
so the same seed gives the same trial configs and suggestions.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Choice(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(len(self.categories)))]


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return float(rng.uniform(self.lower, self.upper))


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float):
        assert lower > 0 and upper > lower
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.lower),
                                        np.log(self.upper))))


class RandInt(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper))


class GridSearch:
    """Marker: every value is enumerated (cartesian with other grids)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def choice(categories: Sequence[Any]) -> Choice:
    return Choice(categories)


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> RandInt:
    return RandInt(lower, upper)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


class TPESearcher:
    """Tree-structured Parzen estimator: model-based sequential search.

    Beyond the reference's surface (Tune there delegates to external search
    libraries; the examples use pure random/grid,
    reference: examples/ray_ddp_example.py:84-89).  After ``n_startup``
    random trials, each Domain dimension splits observed trials into a
    good set (best ``gamma`` fraction) and a bad set, fits a Parzen
    (Gaussian-mixture) density to each, samples candidates from the good
    density and keeps the one maximizing l_good/l_bad — i.e. expected
    improvement under the TPE approximation.  Works with
    choice/uniform/loguniform/randint dims (grid values are treated as
    categorical); non-Domain values pass through.
    """

    def __init__(self, n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 32, seed: int = 0):
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = np.random.default_rng(seed)
        self.metric: str | None = None
        self.mode = "min"
        self._history: List[tuple] = []  # (config, score)

    def set_search_properties(self, metric, mode) -> None:
        self.metric = metric
        self.mode = mode or "min"

    # -- observation transform per domain ------------------------------ #
    @staticmethod
    def _to_unit(domain, value) -> float:
        if isinstance(domain, LogUniform):
            lo, hi = np.log(domain.lower), np.log(domain.upper)
            return (np.log(value) - lo) / (hi - lo)
        if isinstance(domain, (Uniform, RandInt)):
            return (value - domain.lower) / (domain.upper - domain.lower)
        raise TypeError(domain)

    @staticmethod
    def _from_unit(domain, u: float):
        u = float(np.clip(u, 0.0, 1.0))
        if isinstance(domain, LogUniform):
            lo, hi = np.log(domain.lower), np.log(domain.upper)
            # exp(log(x)) can land a float-ulp outside the bounds
            return float(np.clip(np.exp(lo + u * (hi - lo)),
                                 domain.lower, domain.upper))
        if isinstance(domain, RandInt):
            v = domain.lower + u * (domain.upper - domain.lower)
            return int(np.clip(round(v), domain.lower, domain.upper - 1))
        if isinstance(domain, Uniform):
            return float(domain.lower + u * (domain.upper - domain.lower))
        raise TypeError(domain)

    @staticmethod
    def _parzen_logpdf(x: np.ndarray, obs: np.ndarray) -> np.ndarray:
        """Mixture of gaussians at `obs` (unit space), Scott bandwidth with
        a floor so early duplicate observations keep finite spread."""
        bw = max(float(np.std(obs)) * len(obs) ** -0.2, 0.05)
        d2 = (x[:, None] - obs[None, :]) ** 2 / (2 * bw * bw)
        return np.log(np.mean(np.exp(-d2), axis=1) / (bw * np.sqrt(2 * np.pi))
                      + 1e-12)

    def _split(self):
        scores = np.asarray([s for _, s in self._history])
        order = np.argsort(scores if self.mode == "min" else -scores)
        n_good = max(1, int(np.ceil(self.gamma * len(order))))
        return [self._history[i][0] for i in order[:n_good]], \
               [self._history[i][0] for i in order[n_good:]]

    def _suggest_dim(self, key, domain):
        good, bad = self._split()
        if isinstance(domain, (Choice, GridSearch)):
            cats = (domain.categories if isinstance(domain, Choice)
                    else domain.values)
            counts = np.ones(len(cats))  # Laplace smoothing
            for cfg in good:
                # history may predate a spec change: skip entries whose
                # value is no longer a category (or that lack the key)
                if cfg.get(key) in cats:
                    counts[cats.index(cfg[key])] += 1
            return cats[int(self.rng.choice(len(cats),
                                            p=counts / counts.sum()))]
        # same spec-change tolerance as the categorical branch: ignore
        # history entries that predate this dimension or hold a value from
        # an earlier, non-numeric spec (e.g. the key used to be a Choice)
        def usable(c):
            v = c.get(key)
            if not isinstance(v, (int, float, np.integer, np.floating)) \
                    or isinstance(v, bool):
                return False
            # the value must also be valid for the CURRENT domain: e.g. a
            # spec change to LogUniform over old non-positive values would
            # make _to_unit return nan and poison the whole Parzen fit
            with np.errstate(invalid="ignore", divide="ignore"):
                return bool(np.isfinite(self._to_unit(domain, v)))

        good = [c for c in good if usable(c)]
        bad = [c for c in bad if usable(c)]
        if not good and not bad:
            # brand-new dimension on a warm searcher: explore the whole
            # domain like cold start would, instead of pinning to mid-range
            return domain.sample(self.rng)
        g_obs = (np.asarray([self._to_unit(domain, c[key]) for c in good])
                 if good else np.asarray([0.5]))
        b_obs = np.asarray([self._to_unit(domain, c[key]) for c in bad]) \
            if bad else np.asarray([0.5])
        bw = max(float(np.std(g_obs)) * len(g_obs) ** -0.2, 0.05)
        cand = self.rng.normal(g_obs[self.rng.integers(len(g_obs),
                                                       size=self.n_candidates)],
                               bw)
        cand = np.clip(cand, 0.0, 1.0)
        score = self._parzen_logpdf(cand, g_obs) - \
            self._parzen_logpdf(cand, b_obs)
        return self._from_unit(domain, cand[int(np.argmax(score))])

    def suggest(self, config_spec: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        warm = len(self._history) >= self.n_startup
        for k, v in config_spec.items():
            if not isinstance(v, (Domain, GridSearch)):
                out[k] = v
            elif warm:
                out[k] = self._suggest_dim(k, v)
            elif isinstance(v, GridSearch):
                out[k] = v.values[int(self.rng.integers(len(v.values)))]
            else:
                out[k] = v.sample(self.rng)
        return out

    def record(self, config: Dict[str, Any], score: float) -> None:
        self._history.append((dict(config), float(score)))


def generate_trial_configs(config: Dict[str, Any], num_samples: int,
                           seed: int = 0) -> List[Dict[str, Any]]:
    """Expand grids cartesian-style, sample Domains `num_samples` times.

    Matches Tune semantics: num_samples repeats the whole (grid x sample)
    space; plain values pass through.
    """
    config = dict(config or {})
    grid_keys = [k for k, v in config.items() if isinstance(v, GridSearch)]
    grids = [config[k].values for k in grid_keys]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_samples):
        for combo in itertools.product(*grids) if grids else [()]:
            trial_cfg = {}
            for k, v in config.items():
                if isinstance(v, GridSearch):
                    trial_cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    trial_cfg[k] = v.sample(rng)
                else:
                    trial_cfg[k] = v
            out.append(trial_cfg)
    return out
