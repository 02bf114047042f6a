"""EWMA return plots from run CSVs.

Parity: ``plots/plots.py:24-48`` — scan a directory for return CSVs, apply
EWMA smoothing, write ``<name>.png`` — generalized to overlay multiple runs
(the notebook's DDPG-vs-DistDDPG comparison, cell 1). Run as
``python -m d4pg_tpu_torch.analysis.plots <run_dir> [<run_dir> ...]``.
"""

from __future__ import annotations

import csv
import os
import sys

import numpy as np

from d4pg_tpu_torch.analysis.ewma import ewma


def load_returns_csv(
    path: str, column: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Read (step, avg_return[, ewma[, success_rate]]) rows; returns
    (steps, values) for the requested data ``column`` (1 = avg return,
    3 = success rate for sparse-reward/HER runs)."""
    steps, vals = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            try:
                step, val = float(row[0]), float(row[column])
            except (ValueError, IndexError):
                continue  # header, malformed, or column absent in old runs
            steps.append(step)
            vals.append(val)
    return np.asarray(steps), np.asarray(vals)


def plot_runs(
    runs: dict[str, tuple[np.ndarray, np.ndarray]],
    out_path: str,
    alpha: float = 0.95,
    title: str = "returns",
    ylabel: str | None = None,
) -> str:
    """Overlay EWMA-smoothed return curves; writes a PNG, returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, (steps, rets) in sorted(runs.items()):
        if len(steps) == 0:
            continue
        ax.plot(steps, ewma(rets, alpha), label=name)
        ax.plot(steps, rets, alpha=0.2)
    ax.set_xlabel("learner step")
    ax.set_ylabel(ylabel or "avg test return (EWMA)")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    success = "--success" in argv
    argv = [a for a in argv if a != "--success"]
    if not argv:
        print("usage: python -m d4pg_tpu_torch.analysis.plots [--success] "
              "<run_dir> [...]")
        raise SystemExit(2)
    column = 3 if success else 1
    runs = {}
    for run_dir in argv:
        csv_path = os.path.join(run_dir, "returns.csv")
        if not os.path.exists(csv_path):
            print(f"skip {run_dir}: no returns.csv")
            continue
        steps, vals = load_returns_csv(csv_path, column=column)
        if len(steps) == 0:
            # e.g. --success against a pre-success-column CSV: surface it
            # instead of silently plotting an empty axes
            print(f"skip {run_dir}: no data in column {column}")
            continue
        runs[os.path.basename(run_dir.rstrip("/"))] = (steps, vals)
    if not runs:
        print("error: no run dir contained a returns.csv")
        raise SystemExit(1)
    out = plot_runs(
        runs,
        out_path="success.png" if success else "returns.png",
        title="success rate" if success else "returns",
        ylabel="eval success rate (EWMA)" if success else None,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
