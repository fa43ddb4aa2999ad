"""Phase timing + optional device tracing.

The reference instruments every phase with cpu_time::ProcessTime +
SystemTime pairs (embedder.rs:871-884, hubness.rs:42-73) and
memory-stats probes.  Here: wall timers around block_until_ready
boundaries plus optional ``jax.profiler`` traces (SURVEY.md §5), and
the device record every measurement carries.
"""

from __future__ import annotations

import contextlib
import logging
import subprocess
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class PhaseTimer:
    """Collects named phase wall times; ``timings`` maps name -> s."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase.  Arrays to block on can be passed either via
        ``sync=`` directly or by appending to the yielded list — both
        are honored (the dead ``sync=`` parameter previously recorded
        dispatch-only timings for callers who used it)."""
        t0 = time.perf_counter()
        out = [] if sync is None else [sync]
        try:
            yield out
        finally:
            if out:
                try:
                    import jax
                    for leaf in jax.tree_util.tree_leaves(out):
                        if hasattr(leaf, "block_until_ready"):
                            leaf.block_until_ready()
                except Exception:  # pragma: no cover
                    pass
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            logger.info("phase %s: %.3fs", name, dt)

    def summary(self) -> Dict[str, float]:
        out = dict(self.timings)
        out["total"] = sum(self.timings.values())
        return out


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Capture a jax.profiler trace into ``logdir`` (no-op if None).
    View with tensorboard / xprof."""
    if not logdir:
        yield
        return
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("device trace written to %s", logdir)


def require_gpu() -> dict:
    """The device a measurement runs on, as JAX reports it; raises
    ``RuntimeError`` unless it is a GPU (a measurement never falls back
    to the CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devs[0].platform!r} "
                           "devices only")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them
    (read by a child process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
