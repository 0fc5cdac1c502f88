"""Pluggable real-time scheduling core for the persistent dispatcher.

``SchedPolicy`` is the interface (enqueue / pop_next / cancel / admit /
on_retire); ``EdfPolicy`` (default), ``FixedPriorityPolicy``, and
``BudgetedServerPolicy`` are the implementations; ``admission`` holds the
analytic feasibility tests they share. ``make_policy`` resolves the CLI
names ``{"edf", "fp", "server"}``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

from repro_torch.core.sched.admission import AdmissionError
from repro_torch.core.sched.base import (
    CRIT_HIGH, CRIT_LOW, CRITICALITIES, NO_DEADLINE, ClassSpec, QueueItem,
    SchedPolicy, crit_rank,
)
from repro_torch.core.sched.edf import EdfPolicy
from repro_torch.core.sched.fixed_priority import FixedPriorityPolicy
from repro_torch.core.sched.server import BudgetedServerPolicy

POLICIES = {
    EdfPolicy.name: EdfPolicy,
    FixedPriorityPolicy.name: FixedPriorityPolicy,
    BudgetedServerPolicy.name: BudgetedServerPolicy,
}

__all__ = [
    "AdmissionError", "BudgetedServerPolicy", "CRIT_HIGH", "CRIT_LOW",
    "CRITICALITIES", "ClassSpec", "EdfPolicy", "FixedPriorityPolicy",
    "NO_DEADLINE", "POLICIES", "QueueItem", "SchedPolicy", "crit_rank",
    "make_policy",
]


def make_policy(policy: Union[str, SchedPolicy, None],
                classes: Sequence[ClassSpec] = (),
                preemptive: Optional[bool] = None) -> SchedPolicy:
    """Resolve a policy name (or pass through an instance, feeding it any
    ``classes`` it has not seen — specs already declared on the instance
    win, mirroring the shared-dispatcher owner-wins rule). ``preemptive``
    configures chunk-boundary preemption on by-name construction; a
    passed-in instance keeps its own setting unless explicitly
    overridden."""
    if policy is None:
        policy = EdfPolicy.name
    if isinstance(policy, SchedPolicy):
        for spec in classes:
            if policy.spec(spec.opcode) is None:
                policy.set_class(spec)
        if preemptive is not None:
            policy.preemptive = bool(preemptive)
        return policy
    try:
        cls = POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; "
            f"expected one of {sorted(POLICIES)}") from None
    return cls(classes) if preemptive is None \
        else cls(classes, preemptive=preemptive)
