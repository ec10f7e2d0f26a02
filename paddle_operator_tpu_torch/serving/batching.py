"""Request queue + iteration-level (continuous) batching scheduler.

Static batching pays a convoy tax: a batch runs until its LONGEST
sequence finishes, so short requests idle behind long ones and new
arrivals wait a full batch. Continuous batching (the Orca design)
schedules at token granularity instead: every decode iteration the
scheduler admits queued requests into the in-flight batch the moment a
slot (and KV blocks) free up, so the batch composition changes mid-
flight and device utilization tracks offered load, not batch shape.

The pieces:

* :class:`Request` — one user call: prompt ids, a token budget, and the
  timestamps the latency accounting derives ttft/tpot from;
* :class:`RequestQueue` — bounded admission with an explicit shed
  posture (``reject_new``: arrivals bounce when full — backpressure to
  the client; ``drop_oldest``: the stalest queued request is shed to
  admit the new one — freshness over fairness). Every shed is COUNTED:
  no request vanishes without a shed counter recording why;
* :class:`ContinuousBatcher` — the iteration loop: admit up to
  ``max_batch`` in FIFO order, run one engine step over the active set,
  retire finished sequences, and hand each finished request to an
  optional ``metrics`` hook (``observe_request(req, outcome=...)``). The
  engine step is INJECTED (a callable), so tests drive the identical
  scheduler with a deterministic fake step while production wires
  :meth:`.engine.ServingEngine.step_fn`.

A copy of the JAX package's scheduler, which is pure Python; the port
keeps its own so it imports nothing of that package.

Thread safety: queue and batcher state are each owned by their ``_lock``;
the engine step itself runs outside the batcher lock — it is model
compute, not shared state.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: load-shed postures (the JAX package's ``api.types.SERVING_SHED_POLICIES``)
SHED_POLICIES = ("reject_new", "drop_oldest")


@dataclass
class Request:
    """One serving call. Timestamps are filled in by the queue/batcher
    (monotonic clock seconds) and feed the ttft/tpot accounting."""

    request_id: str
    prompt: Sequence[int]
    max_new_tokens: int = 16
    t_arrival: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    generated: List[int] = field(default_factory=list)

    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    def tpot(self) -> float:
        """Steady decode cadence: seconds per output token AFTER the
        first (the first token's latency is ttft's job)."""
        n = len(self.generated)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)


class RequestQueue:
    """Bounded FIFO admission queue with a counted shed posture."""

    def __init__(self, capacity: int, shed_policy: str = "reject_new",
                 clock: Optional[Callable[[], float]] = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if shed_policy not in SHED_POLICIES:
            raise ValueError("shed_policy must be one of %s, got %r"
                             % ("|".join(SHED_POLICIES), shed_policy))
        import time

        self.capacity = capacity
        self.shed_policy = shed_policy
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._q: List[Request] = []
        self._counts: Dict[str, int] = {"submitted": 0, "admitted": 0,
                                        "shed_reject_new": 0,
                                        "shed_drop_oldest": 0}

    def submit(self, req: Request) -> Tuple[bool, Optional[Request]]:
        """Returns ``(accepted, shed)``: ``accepted`` says whether REQ
        got in; ``shed`` is the request dropped to make room (only under
        ``drop_oldest`` — it is the caller's to account/notify)."""
        req.t_arrival = self._clock()
        with self._lock:
            self._counts["submitted"] += 1
            if len(self._q) < self.capacity:
                self._q.append(req)
                return True, None
            if self.shed_policy == "reject_new":
                self._counts["shed_reject_new"] += 1
                return False, None
            shed = self._q.pop(0)
            self._counts["shed_drop_oldest"] += 1
            self._q.append(req)
            return True, shed

    def pop(self) -> Optional[Request]:
        with self._lock:
            if not self._q:
                return None
            req = self._q.pop(0)
            self._counts["admitted"] += 1
            return req

    def requeue_front(self, reqs: Sequence[Request]) -> List[Request]:
        """Preemption path: put in-flight requests BACK at the head (they
        were admitted first; FIFO order is preserved). Requests that no
        longer fit are returned to the caller to shed — never silently
        dropped."""
        overflow: List[Request] = []
        with self._lock:
            for req in reversed(list(reqs)):
                if len(self._q) < self.capacity:
                    self._q.insert(0, req)
                else:
                    overflow.append(req)
        return overflow

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class ContinuousBatcher:
    """Iteration-level scheduler over an injected engine step.

    ``engine_step(active) -> [(token_id, done), ...]`` runs ONE decode
    iteration for the current active set (admission implies the prefill
    for that request happens inside its first step — the engine decides
    how; the batcher only accounts it). ``on_admit`` / ``on_retire``
    hooks let the engine allocate/free KV pages in lockstep with
    scheduling decisions.
    """

    def __init__(self, queue: RequestQueue, max_batch: int,
                 clock: Optional[Callable[[], float]] = None,
                 metrics: Optional[Any] = None,
                 on_admit: Optional[Callable[[Request], bool]] = None,
                 on_retire: Optional[Callable[[Request], None]] = None) -> None:
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        import time

        self.queue = queue
        self.max_batch = max_batch
        self.metrics = metrics
        self.on_admit = on_admit
        self.on_retire = on_retire
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._active: List[Request] = []
        self._counts: Dict[str, int] = {"completed": 0, "admit_deferred": 0,
                                        "preempted": 0, "iterations": 0}

    # -- scheduling ------------------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the queue head. ``on_admit`` returning
        False (KV pool exhausted) defers the request — it goes back to
        the FRONT so admission order is preserved."""
        while True:
            with self._lock:
                if len(self._active) >= self.max_batch:
                    return
            req = self.queue.pop()
            if req is None:
                return
            try:
                admitted = self.on_admit is None or self.on_admit(req)
            except BaseException:
                # the popped slot must not vanish with the exception:
                # retire it as an engine error so request conservation
                # holds, then surface the failure
                if self.metrics is not None:
                    self.metrics.observe_request(req, outcome="error")
                with self._lock:
                    self._counts["admit_error"] = (
                        self._counts.get("admit_error", 0) + 1)
                raise
            if not admitted:
                self.queue.requeue_front([req])
                with self._lock:
                    self._counts["admit_deferred"] += 1
                return
            req.t_admitted = self._clock()
            with self._lock:
                self._active.append(req)

    def step(self, engine_step: Callable[[List[Request]],
                                         List[Tuple[int, bool]]]) -> int:
        """One scheduler iteration: admit, run the engine step, retire.
        Returns how many sequences are still in flight."""
        self._admit()
        with self._lock:
            active = list(self._active)
            self._counts["iterations"] += 1
        if not active:
            return 0
        results = engine_step(active)
        if len(results) != len(active):
            raise RuntimeError(
                "engine step returned %d results for %d sequences"
                % (len(results), len(active)))
        now = self._clock()
        finished: List[Request] = []
        for req, (token, done) in zip(active, results):
            first = not req.generated
            req.generated.append(int(token))
            if first:
                req.t_first_token = now
            if done or len(req.generated) >= req.max_new_tokens:
                req.t_done = now
                finished.append(req)
        with self._lock:
            for req in finished:
                self._active.remove(req)
                self._counts["completed"] += 1
        for req in finished:
            if self.on_retire is not None:
                self.on_retire(req)
            if self.metrics is not None:
                self.metrics.observe_request(req, outcome="ok")
        with self._lock:
            return len(self._active)

    # -- disruption ------------------------------------------------------

    def preempt(self) -> List[Request]:
        """A preemption hit this replica: every in-flight sequence is
        pulled out of the batch (its partial generation is discarded —
        the paged cache dies with the replica) and handed to the caller
        to requeue or shed. Nothing is silently lost."""
        with self._lock:
            victims = list(self._active)
            self._active = []
            self._counts["preempted"] += len(victims)
        for req in victims:
            req.generated = []
            req.t_admitted = req.t_first_token = req.t_done = 0.0
            if self.on_retire is not None:
                self.on_retire(req)
        return victims

    def drain(self,
              engine_step: Callable[[List[Request]],
                                    List[Tuple[int, bool]]],
              max_iterations: int = 10000) -> int:
        """Run to empty WITHOUT admitting new work (graceful shutdown):
        returns iterations used. Raises if the batch does not empty —
        a hung drain must fail loudly, not spin."""
        with self._lock:
            # closing the admission valve = pretending the batch is full
            saved, self.max_batch = self.max_batch, 0
        try:
            for i in range(max_iterations):
                with self._lock:
                    if not self._active:
                        return i
                self.step(engine_step)
            raise RuntimeError("drain did not empty in %d iterations"
                               % max_iterations)
        finally:
            with self._lock:
                self.max_batch = saved

    # -- introspection ---------------------------------------------------

    def in_flight(self) -> int:
        with self._lock:
            return len(self._active)

    def active_ids(self) -> List[str]:
        with self._lock:
            return [r.request_id for r in self._active]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)
