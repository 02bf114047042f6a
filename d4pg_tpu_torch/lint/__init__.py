"""jaxlint for the port — static analysis of ``d4pg_tpu_torch``.

Counterpart of ``d4pg_tpu/lint``. Run as ``python -m d4pg_tpu_torch.lint
[paths]``; library API:

    from d4pg_tpu_torch.lint import lint_paths, lint_source, RULES

It carries the reference's 13 framework-neutral rule families: the
syntactic ``lock-order`` and the whole-program lock graph
(``lockgraph``), wire-protocol registry (``wiregraph``), exception flow
(``failgraph``) and RNG provenance (``rnggraph``). The reference's 11
JAX-only families (they read ``jax.jit``, ``donate_argnums``,
``jax.random``, ``device_put``, ``shard_map`` or ``NamedSharding``) and
its mesh pass have no counterpart here. The rule ids, the CLI flags, the
``--json`` schema and the ``# jaxlint:`` annotation marker are the
reference's, so its fixtures read the same against either package.

Pure stdlib (ast): importing this package imports neither torch nor
anything of the JAX package, so the lint runs on any CPU.
"""

from d4pg_tpu_torch.lint.engine import LintResult, lint_paths, lint_source
from d4pg_tpu_torch.lint.findings import Finding, Suppressions
from d4pg_tpu_torch.lint.rules import RULES

__all__ = ["Finding", "LintResult", "RULES", "Suppressions", "lint_paths",
           "lint_source"]
