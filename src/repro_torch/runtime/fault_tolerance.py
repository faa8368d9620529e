"""Fault-tolerance runtime: failure detection, restart, straggler mitigation.

On a real multi-pod deployment each host runs this supervisor around the
training loop.  The pieces (all exercised by tests with injected faults):

  * **Heartbeats / failure detection** — ``HeartbeatMonitor`` tracks
    per-host last-seen times; a host silent for > ``timeout_s`` is declared
    failed.  (In-process simulation: the test advances a fake clock.)
  * **Restart-from-checkpoint** — ``run_with_recovery`` wraps the step loop;
    any step raising ``WorkerFailure`` rolls back to the latest checkpoint
    and replays.  Because the data pipeline is (seed, step)-pure and the
    train step is deterministic, recovery is *bitwise* identical to a run
    without the failure (asserted in tests).
  * **Straggler mitigation** — ``StragglerMonitor`` keeps a ring buffer of
    per-step durations per host; hosts slower than ``threshold`` × median
    over a window are flagged, and the policy hook decides (log / evict →
    elastic re-shard at the next checkpoint boundary).
  * **Device loss (cluster)** — ``ClusterSupervisor`` watches the
    :class:`~repro_torch.core.hero.HeroCluster` through per-device heartbeats; a
    silent device is declared lost, its residency ledger evicted and its
    in-flight launches rescheduled onto survivors through the cluster's
    active scheduler.  Pinned :class:`~repro_torch.core.hero.DeviceHandle` s homed
    on the lost device (KV caches, resident weights) become unstaged — their
    bytes exist only in host DRAM again — and the supervisor re-stages them
    onto scheduler-picked survivors, charging the full host->device copy
    region on the new lane (the d2d path needs a live source).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Tuple

from repro_torch.core.hero import HeroCluster, LaunchTicket

__all__ = [
    "WorkerFailure",
    "HeartbeatMonitor",
    "StragglerMonitor",
    "ClusterSupervisor",
    "DeviceLossEvent",
    "run_with_recovery",
]


class WorkerFailure(RuntimeError):
    """A (possibly injected) worker/pod failure observed during a step."""


@dataclasses.dataclass
class HeartbeatMonitor:
    num_hosts: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last: Dict[int, float] = {h: now for h in range(self.num_hosts)}

    def beat(self, host: int) -> None:
        self._last[host] = self.clock()

    def failed_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self._last.items() if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.failed_hosts()


@dataclasses.dataclass
class StragglerMonitor:
    num_hosts: int
    window: int = 16
    threshold: float = 1.8

    def __post_init__(self):
        self._times: Dict[int, deque] = {
            h: deque(maxlen=self.window) for h in range(self.num_hosts)
        }

    def record(self, host: int, step_s: float) -> None:
        self._times[host].append(step_s)

    def medians(self) -> Dict[int, float]:
        out = {}
        for h, dq in self._times.items():
            if dq:
                s = sorted(dq)
                out[h] = s[len(s) // 2]
        return out

    def stragglers(self) -> List[int]:
        med = self.medians()
        if len(med) < 2:
            return []
        global_median = sorted(med.values())[len(med) // 2]
        if global_median <= 0:
            return []
        return [h for h, m in med.items() if m > self.threshold * global_median]


@dataclasses.dataclass(frozen=True)
class DeviceLossEvent:
    """One observed device loss and where its work went."""

    device_id: int
    rescheduled: Tuple[Tuple[LaunchTicket, int], ...]  # (ticket, new device)
    evicted_buffers: Tuple[str, ...]
    # True when no survivor existed: in-flight work was dropped, not moved.
    total_loss: bool = False
    # Pinned handles that were homed on the lost device (now unstaged) ...
    unstaged_handles: Tuple[str, ...] = ()
    # ... and where each was re-staged: (handle name, new device id).
    restaged: Tuple[Tuple[str, int], ...] = ()


@dataclasses.dataclass
class ClusterSupervisor:
    """Device-level failure handling for a :class:`HeroCluster`.

    The host heartbeats each virtual PMCA (on real HW: the mailbox/doorbell
    the HeroSDK runtime already polls).  A device silent past ``timeout_s``
    is failed: residency evicted, queue rescheduled, event logged.  A later
    ``recover(device_id)`` brings the device back cold — its ledger stays
    empty until callers re-pin buffers, so the cost model charges the copy
    region again, exactly what re-staging after a reset costs.
    """

    cluster: HeroCluster
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last: Dict[int, float] = {
            d.device_id: now for d in self.cluster.devices
        }
        self.events: List[DeviceLossEvent] = []

    def beat(self, device_id: int) -> None:
        self._last[device_id] = self.clock()

    def silent_devices(self) -> List[int]:
        now = self.clock()
        return [
            d.device_id
            for d in self.cluster.alive_devices()
            if now - self._last.get(d.device_id, now) > self.timeout_s
        ]

    def fail_device(self, device_id: int) -> DeviceLossEvent:
        """Declare one device lost: evict + reschedule, return the event.

        Losing the *last* device is still recorded (``total_loss=True``,
        in-flight work dropped) rather than raised — the supervisor's job
        is to report every loss, not to die partway through a sweep.

        Handles pinned to the lost device come back unstaged from
        ``cluster.fail_device``; the supervisor immediately re-stages each
        onto a scheduler-picked survivor (full host copy charged on the new
        lane), so the caches survive the loss with their cost paid visibly.
        """
        dev = self.cluster.device(device_id)
        evicted = tuple(sorted(dev.resident))
        lost_handles = tuple(
            sorted(h.name for h in self.cluster.handles_on(device_id))
        )
        try:
            moved = self.cluster.fail_device(device_id)
            total_loss = False
        except RuntimeError:  # no reschedule target: whole cluster is down
            dev.fail()
            moved = []
            total_loss = True
            for name in lost_handles:  # unstaged, nowhere to re-stage
                h = self.cluster.handle(name)
                if h is not None:
                    self.cluster.unstage_handle(h)
        restaged = []
        if not total_loss:
            for name in lost_handles:
                h = self.cluster.handle(name)
                if h is not None and not h.valid:
                    self.cluster.restage_handle(h)
                    restaged.append((name, h.device_id))
        ev = DeviceLossEvent(
            device_id=device_id,
            rescheduled=tuple(moved),
            evicted_buffers=evicted,
            total_loss=total_loss,
            unstaged_handles=lost_handles,
            restaged=tuple(restaged),
        )
        self.events.append(ev)
        return ev

    def poll(self) -> List[DeviceLossEvent]:
        """Fail every heartbeat-silent device; returns the new events."""
        return [self.fail_device(d) for d in self.silent_devices()]

    def recover(self, device_id: int) -> None:
        self.cluster.restore_device(device_id)
        self._last[device_id] = self.clock()

    def resync(self) -> None:
        """Re-key the heartbeat table to the cluster's current topology
        (elastic resize at a checkpoint boundary adds/removes devices)."""
        now = self.clock()
        current = {d.device_id for d in self.cluster.devices}
        self._last = {
            i: self._last.get(i, now) for i in sorted(current)
        }


def run_with_recovery(
    *,
    num_steps: int,
    start_step: int,
    step_fn: Callable[[int], Tuple[object, float]],
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], int],
    checkpoint_every: int = 10,
    max_restarts: int = 5,
):
    """Drive the step loop with checkpoint/restart semantics.

    ``step_fn(step) -> (metrics, step_seconds)`` may raise WorkerFailure.
    ``restore_fn() -> step`` rolls state back and returns the resume step.
    Returns (final_step, metrics_log, num_restarts)."""
    log: List[object] = []
    restarts = 0
    step = start_step
    while step < num_steps:
        try:
            metrics, _dur = step_fn(step)
            log.append((step, metrics))
            step += 1
            if step % checkpoint_every == 0:
                save_fn(step)
        except WorkerFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore_fn()
    return step, log, restarts
