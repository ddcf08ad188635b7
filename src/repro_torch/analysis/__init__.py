"""The port's lint and its dynamic twin, in torch idioms.

``python -m repro_torch.analysis src/repro_torch examples/torch_*.py``
runs the RPL001–RPL009 catalog (:mod:`.rules`) with the JAX package's rule
ids, suppression grammar, SARIF output, baseline diffing and ``--fix``;
:func:`trace_audit` counts the engine's step signatures per callsite.

The dataflow tier: :mod:`.cfg` builds intraprocedural control-flow
graphs, :mod:`.dataflow` runs forward fixpoints over them, :mod:`.taint`
is the factor-mask lattice behind RPL005, and :mod:`.shapes` is the
abstract shape/dtype/layout interpreter behind RPL009, which checks the
kernel path against the Hopper contract table
(:mod:`repro_torch.kernels.constraints`). The package imports neither JAX
nor the JAX package.
"""
from repro_torch.analysis.core import (
    Finding,
    Rule,
    TextEdit,
    get_rules,
    lint_paths,
    register_rule,
)
from repro_torch.analysis.trace_audit import TraceAudit, trace_audit

__all__ = [
    "Finding",
    "Rule",
    "TextEdit",
    "TraceAudit",
    "get_rules",
    "lint_paths",
    "register_rule",
    "trace_audit",
]
