"""Offline analysis: run loggers, EWMA return plots, actor scaling.

Counterpart of ``d4pg_tpu/analysis/``; numpy only (matplotlib is imported
inside the plotting functions). Like the JAX package, it replaces the
original implementation's ``plots/plots.py`` (CSV scan -> EWMA -> PNG) and
the ``plotUtil.ipynb`` ``Logger`` class (named-series dict logs with pickle
persistence and comparison plots) with importable, tested equivalents.
"""

from d4pg_tpu_torch.analysis.ewma import ewma
from d4pg_tpu_torch.analysis.logger import RunLogger
from d4pg_tpu_torch.analysis.plots import load_returns_csv, plot_runs

__all__ = ["ewma", "RunLogger", "load_returns_csv", "plot_runs"]
