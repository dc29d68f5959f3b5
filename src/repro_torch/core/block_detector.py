"""Block detection and report management (paper §V-A, §VII-A).

The block detector sits where the paper's MPI wrapper sits: at every
blocking communication call it emits a *report message*

    alpha = (s, i, B, p_g)

with the node state s (Blocked/Running), the node index i, the blocker set
B, and the power gain p_g (Eq. 3).  The :class:`ReportManager` implements
the §VII-A2 debounce: reports are buffered for one break-even period (the
ski-rental rule — break-even = round-trip time of report + distribute);
if a Blocked report is cancelled by a Running report within the window,
both are dropped, avoiding thrashing of the CPU frequency and controller.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import FrozenSet, List, Optional


class NodeState(enum.Enum):
    RUNNING = "Running"
    BLOCKED = "Blocked"


@dataclass(frozen=True)
class ReportMessage:
    """alpha = (s, i, B, p_g) — §V-A."""

    state: NodeState
    node: int
    blockers: FrozenSet[int]
    power_gain_w: float
    sent_at: float = 0.0


@dataclass(frozen=True)
class DistributeMessage:
    """gamma = (i, p_b) — Algorithm 1 line 44."""

    node: int
    power_bound_w: float


@dataclass
class ReportManager:
    """Per-node debouncing buffer (ski-rental break-even, §VII-A2).

    ``breakeven_s`` should equal the report->distribute round-trip time.
    Usage: on every state change call :meth:`offer`; the manager returns
    the messages that are actually due for transmission at ``flush`` time.
    """

    node: int
    breakeven_s: float
    _pending: Optional[ReportMessage] = None
    _pending_since: float = 0.0
    sent: int = 0
    suppressed: int = 0

    def offer(self, msg: ReportMessage, now: float) -> List[ReportMessage]:
        """Offer a state-change message; returns messages ready to send."""
        out: List[ReportMessage] = []
        if self._pending is None:
            self._pending = msg
            self._pending_since = now
            return out
        if self._pending.state != msg.state:
            # opposing pair within the window -> drop both (ski-rental:
            # the block ended before the rent-vs-buy break-even point)
            if now - self._pending_since < self.breakeven_s:
                self._pending = None
                self.suppressed += 2
                return out
            out.append(self._pending)
            self.sent += 1
            self._pending = msg
            self._pending_since = now
            return out
        # same-state update (e.g. refreshed blocker set): replace
        self._pending = msg
        return out

    def poll(self, now: float) -> List[ReportMessage]:
        """Emit the pending message once its break-even window has passed.

        The 1e-9 slack absorbs float error when a poll fires at exactly
        ``pending_since + breakeven`` (e.g. a discrete-event scheduler).
        """
        if (self._pending is not None
                and now - self._pending_since >= self.breakeven_s - 1e-9):
            msg = self._pending
            self._pending = None
            self.sent += 1
            return [msg]
        return []

    def next_deadline(self) -> Optional[float]:
        if self._pending is None:
            return None
        return self._pending_since + self.breakeven_s


def blocked_report(node: int, blockers, power_gain_w: float,
                   now: float) -> ReportMessage:
    return ReportMessage(state=NodeState.BLOCKED, node=node,
                         blockers=frozenset(blockers),
                         power_gain_w=power_gain_w, sent_at=now)


def running_report(node: int, now: float) -> ReportMessage:
    """s = Running -> B is empty (§V-A)."""
    return ReportMessage(state=NodeState.RUNNING, node=node,
                         blockers=frozenset(), power_gain_w=0.0, sent_at=now)
