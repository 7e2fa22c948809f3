"""Statistical significance for ablation gains.

Copy of ``mmrp_tpu/eval/significance.py`` (numpy and scipy).

The reference README advertises "Statistical significance for ablation
gains (paired t-test)" (reference: README.md:82,112) but ships no code
for it — the variant eval (src/Evaluate/retrieval_eval_variants.py:31-153)
reports means only. This module supplies the missing capability: paired
per-query comparisons between two retrieval variants.

Given per-query metric vectors a (treatment) and b (baseline) over the
SAME query set:

- paired t-test on the deltas d = a - b (scipy.stats.ttest_rel);
- Wilcoxon signed-rank test, robust to non-normal deltas (ties/zeros
  dropped, as is standard);
- percentile-bootstrap 95% CI of the mean delta (deterministic seed) —
  the effect-size view the p-values lack.

All metrics here are per-query in [0, 1] (AP, P@K, nDCG@K, RR), so
paired designs are appropriate: the per-query pairing removes the large
query-difficulty variance component.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np


def paired_tests(
    a: Sequence[float],
    b: Sequence[float],
    n_boot: int = 2000,
    seed: int = 0,
) -> Dict[str, float]:
    """Paired comparison of per-query metric vectors ``a`` vs ``b``.

    Returns mean_delta (mean(a-b)), t/p from the paired t-test,
    Wilcoxon p, and the bootstrap 95% CI of the mean delta. Degenerate
    inputs return defined values rather than raising (mirroring
    eval/metrics.py's safe_* conventions): <2 queries or any non-finite
    delta -> NaN p-values; all-zero deltas -> p=1; constant nonzero
    deltas -> the exact sign-test p (zero variance is maximal evidence,
    not NaN).
    """
    from scipy import stats

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(
            f"paired_tests: unequal query counts {a.shape} vs {b.shape}"
        )
    d = a - b
    n = d.size
    out: Dict[str, float] = {
        "n": float(n),
        "mean_delta": float(d.mean()) if n else float("nan"),
        "t": float("nan"),
        "p_ttest": float("nan"),
        "p_wilcoxon": float("nan"),
        "ci95_lo": float("nan"),
        "ci95_hi": float("nan"),
    }
    if n < 2 or not np.all(np.isfinite(d)):
        # non-finite deltas would otherwise fall through every branch
        # below into the constant-nonzero case (ptp(d) is NaN) and report
        # maximal significance for corrupted input
        return out
    if np.ptp(d) > 0:
        t, p = stats.ttest_rel(a, b)
        out["t"], out["p_ttest"] = float(t), float(p)
        try:
            out["p_wilcoxon"] = float(stats.wilcoxon(d).pvalue)
        except ValueError:  # all-zero after tie removal
            pass
    elif np.all(d == 0):
        # identical rankings: no evidence of difference
        out["p_ttest"] = out["p_wilcoxon"] = 1.0
    else:
        # constant NONZERO delta (ptp==0, d!=0): zero variance makes the
        # t statistic infinite, not undefined — every query moved the same
        # direction, the strongest possible paired evidence (realistic for
        # quantized metrics like P@K on small query sets). Report the
        # exact two-sided sign-test value, 2 * (1/2)^n, which equals the
        # Wilcoxon signed-rank p for n same-signed equal-magnitude deltas.
        p_exact = min(1.0, 2.0 ** (1 - n))
        out["t"] = float(np.sign(d[0]) * np.inf)
        out["p_ttest"] = out["p_wilcoxon"] = float(p_exact)

    # chunked bootstrap: the full (n_boot, n) index + resample matrices
    # would peak at ~1.6 GB for 50k-query sets; 100 replicates at a time
    # is numerically identical with ~1/20th the footprint
    rng = np.random.default_rng(seed)
    boots = np.empty(n_boot, np.float64)
    step = max(1, min(n_boot, (2 ** 22) // max(n, 1)))
    for s in range(0, n_boot, step):
        e = min(s + step, n_boot)
        idx = rng.integers(0, n, size=(e - s, n))
        boots[s:e] = d[idx].mean(axis=1)
    out["ci95_lo"] = float(np.percentile(boots, 2.5))
    out["ci95_hi"] = float(np.percentile(boots, 97.5))
    return out


def compare_variants(
    per_query: Mapping[str, Mapping[str, Sequence[float]]],
    baseline: str = "baseline",
    metrics: Sequence[str] = ("AP", "RR"),
    n_boot: int = 2000,
    seed: int = 0,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Each non-baseline variant vs the baseline, per metric.

    ``per_query``: {variant: {metric: per-query vector}} as produced by
    eval/retrieval_eval.py::evaluate_gallery(per_query=True).
    """
    base = per_query[baseline]
    return {
        name: {
            m: paired_tests(vecs[m], base[m], n_boot=n_boot, seed=seed)
            for m in metrics
            if m in vecs and m in base
        }
        for name, vecs in per_query.items()
        if name != baseline
    }
