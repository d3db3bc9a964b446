# Copied from src/repro/runtime/chaos.py; imports point at repro_torch.
"""Deterministic fault injection for the serving fleet.

Robustness claims need a falsifier: :class:`ChaosInjector` attaches to a
:class:`~repro_torch.runtime.fleet.Fleet` through each replica Session's launch
hook (``Session.set_launch_hook``) and fires scripted faults at exact launch
counts — no randomness, so a chaos run (``chip_smoke.py``'s fleet phase)
reproduces bit-for-bit:

* ``kill(rid)``        — every launch on the replica raises (a crashed
  device: the fleet must evict and retry elsewhere);
* ``poison(rid, n)``   — the next ``n`` launches raise, then the replica is
  healthy again (a transient fault: strikes, maybe eviction, then the
  warmup probe re-admits it);
* ``hang(rid)``        — launches block until :meth:`heal` (a wedged DMA:
  the attempt timeout must fire and the request drain elsewhere while the
  hung thread is duplicate-suppressed on wakeup);
* ``slow(rid, delay)`` — launches sleep first (a straggler: the step-time
  EWMA climbs until the straggler detector evicts; also the knob the bench
  uses to inject a uniform launch cost so scaling measurements are
  device-bound rather than host-BLAS-bound).

Faults trigger *after* ``after_launches`` healthy launches on that replica
(0 = immediately), so "kill r1 mid-run" is expressible as data.  Every
fired fault is appended to :attr:`ChaosInjector.log` for the bench to
assert against.  ``heal(rid)`` clears faults and releases hangs.
"""
from __future__ import annotations

import threading
import time


class ChaosError(RuntimeError):
    """The injected fault — distinguishable from real executor errors."""


class ChaosInjector:
    """Scripted, launch-counted fault injection on fleet replicas."""

    def __init__(self, *, clock=time.monotonic, sleep=time.sleep):
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._faults: dict[str, list[dict]] = {}    # rid -> active faults
        self._launches: dict[str, int] = {}         # rid -> launch count
        self._hang_gates: dict[str, threading.Event] = {}
        self._fleet = None
        self.log: list[dict] = []       # every fired fault, in order

    # ---------------------------------------------------------------- attach
    def attach(self, fleet) -> "ChaosInjector":
        """Install this injector's hook on every replica of ``fleet``
        (idempotent; replaces any previous hook)."""
        self._fleet = fleet
        for rid, r in fleet.replicas().items():
            r.session.set_launch_hook(self._hook(rid))
        return self

    def detach(self) -> None:
        if self._fleet is not None:
            for r in self._fleet.replicas().values():
                r.session.set_launch_hook(None)
        self.heal_all()

    # ---------------------------------------------------------------- faults
    def _arm(self, rid: str, fault: dict) -> None:
        with self._lock:
            self._faults.setdefault(rid, []).append(fault)

    def kill(self, rid: str, *, after_launches: int = 0) -> None:
        """Every launch on ``rid`` raises once armed — a dead replica."""
        self._arm(rid, {"kind": "kill", "after": after_launches})

    def poison(self, rid: str, n_launches: int = 1, *,
               after_launches: int = 0) -> None:
        """The next ``n_launches`` launches raise, then healthy again."""
        self._arm(rid, {"kind": "poison", "after": after_launches,
                        "left": int(n_launches)})

    def hang(self, rid: str, *, after_launches: int = 0) -> None:
        """Launches block until :meth:`heal`; the blocked launch then
        proceeds (its late result is the fleet's duplicate to suppress)."""
        with self._lock:
            self._hang_gates.setdefault(rid, threading.Event()).clear()
        self._arm(rid, {"kind": "hang", "after": after_launches})

    def slow(self, rid: str, delay_s: float, *, after_launches: int = 0,
             n_launches: int | None = None) -> None:
        """Launches sleep ``delay_s`` first; ``n_launches=None`` = forever."""
        self._arm(rid, {"kind": "slow", "after": after_launches,
                        "delay": float(delay_s),
                        "left": None if n_launches is None else int(n_launches)})

    def heal(self, rid: str) -> None:
        """Clear every fault on ``rid`` and release any hung launch."""
        with self._lock:
            self._faults.pop(rid, None)
            gate = self._hang_gates.get(rid)
        if gate is not None:
            gate.set()

    def heal_all(self) -> None:
        for rid in list(self._faults) + list(self._hang_gates):
            self.heal(rid)

    def fired(self, kind: str | None = None, rid: str | None = None) -> int:
        with self._lock:
            return sum(1 for e in self.log
                       if (kind is None or e["kind"] == kind)
                       and (rid is None or e["rid"] == rid))

    # ------------------------------------------------------------------ hook
    def _hook(self, rid: str):
        def on_launch(x) -> None:
            with self._lock:
                self._launches[rid] = n = self._launches.get(rid, 0) + 1
                todo = []
                for f in list(self._faults.get(rid, ())):
                    if f["after"] > 0:      # still counting healthy launches
                        f["after"] -= 1
                        continue
                    todo.append(f)
                    if f["kind"] == "poison":
                        f["left"] -= 1
                        if f["left"] <= 0:
                            self._faults[rid].remove(f)
                    elif f["kind"] == "slow" and f["left"] is not None:
                        f["left"] -= 1
                        if f["left"] <= 0:
                            self._faults[rid].remove(f)
                for f in todo:
                    self.log.append({"rid": rid, "kind": f["kind"],
                                     "launch": n})
                gate = self._hang_gates.get(rid)
            # fire OUTSIDE the lock: hangs and sleeps must not serialize
            # other replicas' hooks
            for f in todo:
                if f["kind"] == "slow":
                    self._sleep(f["delay"])
                elif f["kind"] == "hang":
                    if gate is not None:
                        gate.wait()
                elif f["kind"] == "kill":
                    raise ChaosError(f"chaos: replica {rid} killed "
                                     f"(launch {n})")
                elif f["kind"] == "poison":
                    raise ChaosError(f"chaos: replica {rid} poisoned launch "
                                     f"{n}")
        return on_launch
