"""Admission policies for the render serving engine (port of
``repro.serve.policies``).

When a slot drains, the :class:`~repro_torch.serve.render_engine.
RenderServeEngine` asks its policy which queued session takes it
(``select``) and, before each admission pass, which queued sessions to drop
(``shed``, optional). A policy never interrupts a session mid-flight: the
warp window is the preemption quantum.

* :class:`FifoPolicy` — submission order; sheds nothing.
* :class:`PriorityPolicy` — highest ``priority``, then least remaining
  ``deadline_ms`` budget, then submission order; sheds queued sessions
  whose deadline already expired.
"""
from __future__ import annotations

import math
from typing import Protocol, Sequence, Union, runtime_checkable


@runtime_checkable
class SchedulingPolicy(Protocol):
    """Selects which queued session is admitted into a drained slot.

    ``queue`` holds sessions (each carries ``priority``, ``deadline_ms``,
    ``arrival`` and ``submitted_s``); ``now_s`` is the engine's wall clock.
    A policy may also implement ``shed(queue, now_s) -> indices``; the
    engine treats a missing ``shed`` as "shed nothing".
    """

    name: str

    def select(self, queue: Sequence[object], now_s: float) -> int:
        ...


class FifoPolicy:
    """Admission in submission order."""

    name = "fifo"

    def select(self, queue: Sequence[object], now_s: float) -> int:
        return 0

    def shed(self, queue: Sequence[object], now_s: float) -> Sequence[int]:
        return ()


class PriorityPolicy:
    """Priority-then-deadline admission with FIFO tie-breaking."""

    name = "priority"

    @staticmethod
    def _remaining_s(session, now_s: float) -> float:
        if getattr(session, "deadline_ms", None) is None:
            return math.inf
        submitted = getattr(session, "submitted_s", None)
        base = submitted if submitted is not None else now_s
        return base + session.deadline_ms / 1e3 - now_s

    def select(self, queue: Sequence[object], now_s: float) -> int:
        return min(
            range(len(queue)),
            key=lambda i: (-getattr(queue[i], "priority", 0),
                           self._remaining_s(queue[i], now_s),
                           getattr(queue[i], "arrival", i)))

    def shed(self, queue: Sequence[object], now_s: float) -> Sequence[int]:
        """Drop queued sessions whose deadline expired while waiting."""
        return [i for i, sess in enumerate(queue)
                if self._remaining_s(sess, now_s) < 0.0]


def resolve_policy(policy: Union[None, str, SchedulingPolicy]
                   ) -> SchedulingPolicy:
    """None -> FIFO; "fifo"/"priority" -> the builtin; objects with
    ``name`` and ``select`` pass through."""
    if policy is None:
        return FifoPolicy()
    if isinstance(policy, str):
        try:
            return {"fifo": FifoPolicy, "priority": PriorityPolicy}[policy]()
        except KeyError:
            raise ValueError(f"unknown scheduling policy {policy!r} "
                             "(builtins: fifo, priority)") from None
    if not isinstance(policy, SchedulingPolicy):
        raise TypeError(f"{policy!r} does not implement SchedulingPolicy "
                        "(needs .name and .select(queue, now_s))")
    return policy
