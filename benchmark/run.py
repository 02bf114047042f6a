#!/usr/bin/env python3
"""The benchmark of ``d4pg_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell, its configuration, traffic and metrics come from
``BENCHMARK.json`` and the files it names (``harness/spec.py``). The run
sets the program up from ``--seed``, checks its first grad steps against
the plain reference, warms up, measures for ``--seconds``, and with
``--trace 1`` traces a few chunks more. It prints one JSON line last on
standard output: ``correct``, ``attempted`` and ``failed`` grad steps,
the end-to-end metrics (``--trace 0``) or the per-layer metrics
(``--trace 1``), the device, with ``--trace 1`` the trace's breakdown,
and last the numbers compared with their limits, which also end
standard error. Without the cards, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits 2 or 3.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@dataclasses.dataclass
class Context:
    """What a metric's reader gets (``metrics/<name>.py``)."""

    cell: object
    outcome: dict
    kind: str

    def plugin(self, folder: str, name: str):
        from harness import spec

        return spec.plugin(folder, name)

    @property
    def precision(self) -> str:
        cfg = self.cell.config
        if cfg["compute_dtype"] == "float32" and cfg.get("tf32"):
            return "tf32"
        return cfg["compute_dtype"]

    def peak(self, key: str):
        from harness import spec

        table = spec.load_json(BENCH / "flops" / "peaks.json")
        return table.get(self.kind, {}).get(key)

    def flops_per_step(self) -> int:
        t = self.cell.traffic
        batch = int(t["batch_size"]) * int(t.get("ranks", 1))
        return self.plugin("flops", self.cell.config["family"]) \
            .flops_per_step(self.cell.config, batch)

    def kernel_s(self, *names: str) -> float:
        tr = self.outcome.get("trace")
        if tr is None:
            return 0.0
        return sum(s for k, s in tr.device_s.items()
                   if any(n.lower() in k.lower() for n in names))


def _caches() -> None:
    """Every cache a run could write, at fixed paths in the checkout."""
    out = BENCH / "out" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(out / sub)


def metrics(ctx: Context, entries: list) -> dict:
    out = {}
    for m in entries:
        value = ctx.plugin("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    from harness import check, learn, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner = spec.plugin("runners", cell.traffic["runner"])
    outcome = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START)
    banned = sorted(set(outcome["banned"]) | set(learn.banned_modules()))
    if banned:
        print(f"banned modules loaded: {banned}", file=sys.stderr)
        return 3
    ok, shown = check.verdict(outcome["numbers"], cell.limits)
    ok = ok and outcome["nonfinite"] == 0
    ctx = Context(cell, outcome, torch.cuda.get_device_name(0))
    device = {"platform": "gpu", "kind": ctx.kind, "count": cell.chips,
              "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    result = {"correct": bool(ok), "attempted": outcome["steps"],
              "failed": outcome["nonfinite"],
              "metrics": metrics(ctx, cell.per_layer if args.trace
                                 else cell.end_to_end),
              "device": device}
    tr = outcome.get("trace")
    if tr is not None:
        from harness.trace import top

        print(f"trace: {tr.launches} launches, {tr.device_events} device "
              f"events, busy {tr.busy_s:.4f} s of {tr.window_s:.4f} s "
              f"({tr.wall_s:.4f} s on the host clock), "
              f"{outcome['trace_steps']} steps", file=sys.stderr)

        device["busy_s"] = outcome["busy_s"]
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": top(tr.device_s),
                               "idle_gaps": top(tr.gaps)}
    result["checks"] = shown
    print("chunk s: " + " ".join(f"{c:.3f}" for c in outcome["chunk_s"]),
          file=sys.stderr)
    chunks = sorted(outcome["chunk_s"])
    print(f"fill {outcome['fill_s']:.3f} s, window {outcome['elapsed']:.3f}"
          f" s, {outcome['steps']} steps; host s per chunk: min "
          f"{chunks[0]:.4f}, median {chunks[len(chunks) // 2]:.4f}, max "
          f"{chunks[-1]:.4f}", file=sys.stderr)
    (BENCH / "out").mkdir(exist_ok=True)
    with open(BENCH / "out" / f"{args.workload}.json", "w") as f:
        json.dump(result, f)
    for name, s in shown.items():
        print(f"check {name} {s['value']!r} limit {s['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
