"""The SPMD command stream: how rank 0 drives the followers.

Rank 0 runs the HTTP service, the tokenizers, the encoder and the kNN;
every rank holds its shard of the Llama weights and runs the same engine
calls in the same order. Before rank 0 runs an engine call that reaches a
collective, it broadcasts the call on the mesh's gloo control group as a
command, ``(name, payload)``, the payload numpy arrays and plain Python
(the assembled prompt, the sampler's generator state, the token budget,
whether to speculate). A follower loops: receive a command, run it
(``serve_commands``). Every host decision that could differ between ranks
(a fault armed, a deadline, the speculation switch, a shadow audit) is made
on rank 0 and reaches the followers inside a command, so no rank enters a
collective on its own clock.

``CommandStream.lock`` serializes sending a command with running it on
rank 0: two threads (a request and the shadow auditor) can never interleave
their collectives. A heartbeat thread sends ``heartbeat`` while the stream
is idle, so the followers' waiting broadcast never reaches the group's
timeout, and gathers every rank's device memory (``peer_stats``, read by
``obs/devices.py``). A collective that fails marks the stream broken:
``ready()`` turns false and every later call raises.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def device_stats(ctx) -> Dict[str, int]:
    """This rank's card memory: its index, the caching allocator's live
    bytes and the card's total (zeros on the CPU)."""
    dev = ctx.device
    if dev.type != "cuda":
        return {"rank": ctx.rank, "device": 0, "allocated": 0, "total": 0}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"rank": ctx.rank, "device": idx, "allocated": int(torch.cuda.memory_allocated(idx)),
            "total": int(torch.cuda.get_device_properties(idx).total_memory)}


class CommandStream:
    """Rank 0's side of the command stream over ``ctx``'s control group."""

    def __init__(self, ctx):
        if not ctx.leader:
            raise ValueError("only rank 0 sends commands")
        self.ctx = ctx
        self.lock = threading.RLock()
        self.sent = 0
        self.broken: Optional[str] = None
        self.stopped = False
        self.peer_stats: Dict[int, Dict[str, int]] = {}
        self._last = time.monotonic()
        self._stop_beat = threading.Event()
        self._beat: Optional[threading.Thread] = None

    def send(self, name: str, **payload) -> None:
        """Broadcast one command; the caller holds ``lock`` until it has
        run the call itself."""
        if self.broken is not None or self.stopped:
            raise RuntimeError(f"the command stream is {'broken: ' + self.broken if self.broken else 'stopped'}")
        try:
            self.ctx.broadcast_object((name, payload))
        except Exception as e:
            self.broken = f"{name}: {e!r}"
            logger.error("command %s failed to reach the followers: %r", name, e)
            raise
        self.sent += 1
        self._last = time.monotonic()

    def call(self, name: str, fn: Callable, **payload):
        """Send ``name`` and run ``fn()`` here, under the lock."""
        with self.lock:
            self.send(name, **payload)
            try:
                return fn()
            except Exception as e:
                # the followers ran (or are running) the same call: this
                # rank's collectives no longer line up with theirs
                self.broken = f"{name} on rank 0: {e!r}"
                raise

    def heartbeat(self) -> Dict[int, Dict[str, int]]:
        """One ``heartbeat`` command: every rank's ``device_stats`` (the
        last ones once the stream has stopped)."""
        with self.lock:
            if self.stopped:
                return self.peer_stats
            self.send("heartbeat")
            try:
                got = self.ctx.gather_object(device_stats(self.ctx))
            except Exception as e:
                self.broken = f"heartbeat: {e!r}"
                raise
        self.peer_stats = {s["rank"]: s for s in got}
        return self.peer_stats

    def start_heartbeat(self, interval_s: float) -> None:
        """Beat every ``interval_s`` of idleness (well inside the groups'
        timeout)."""
        self.heartbeat()

        def loop():
            while not self._stop_beat.wait(interval_s / 4):
                if self.broken is not None or self.stopped:
                    return
                if time.monotonic() - self._last < interval_s:
                    continue
                try:
                    self.heartbeat()
                except Exception:  # noqa: BLE001 — broken is set; ready() reports it
                    logger.exception("heartbeat failed: a follower is gone")
                    return

        self._beat = threading.Thread(target=loop, daemon=True, name="mesh-heartbeat")
        self._beat.start()

    def ready(self) -> bool:
        """Whether every follower is following: no failed collective, not
        stopped, and the heartbeat (once started) still beating."""
        if self.broken is not None or self.stopped:
            return False
        return self._beat is None or self._beat.is_alive()

    def stop(self) -> None:
        """Send ``stop``: the followers leave their loops."""
        self._stop_beat.set()
        with self.lock:
            if not self.stopped and self.broken is None:
                self.send("stop")
            self.stopped = True
        if self._beat is not None and self._beat is not threading.current_thread():
            self._beat.join(timeout=5.0)


def serve_commands(ctx, engine) -> int:
    """A follower's loop: run each command rank 0 sends on ``engine``
    (``InferenceEngine.run_command``) until ``stop``; returns the calls
    run. An exception leaves the loop: the caller exits non-zero."""
    n = 0
    while True:
        name, payload = ctx.broadcast_object(None)
        if name == "stop":
            return n
        if name == "heartbeat":
            ctx.gather_object(device_stats(ctx))
            continue
        engine.run_command(name, payload)
        n += 1
