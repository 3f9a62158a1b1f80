"""Profiling harness: wall-clock rays/s counters, jax.profiler traces, and
a first-order roofline account for the traversal loop.

The reference's only instrumentation is Stopwatch logging of clipmap updates
(Clipmap.cs:46-47,128-137) and an uncapped frame counter
(RaytracingMaster.cs:21-22); SURVEY.md §5 asks for real traces + rays/s +
roofline accounting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class RaysPerSecond:
    """Accumulating rays/s counter (the FPS counter analog)."""

    rays: int = 0
    seconds: float = 0.0
    frames: int = 0

    @contextlib.contextmanager
    def frame(self, n_rays: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.rays += n_rays
        self.frames += 1

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (f"{self.frames} frames, {self.rays:.3g} rays in "
                f"{self.seconds:.2f}s = {self.rays_per_s/1e6:.2f} Mrays/s")


def fenced_median_ms(fn, runs: int) -> float:
    """Median wall time in ms of `runs` calls of fn(), each fenced with
    jax.block_until_ready (JAX returns before the device finishes), after
    one untimed call that compiles."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Published peak device-memory bandwidth, keyed by jax device_kind.
# NVIDIA H100 SXM5 80GB data sheet: 3.35 TB/s HBM3 (at the 700 W limit).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    """Peak HBM bandwidth of `device_kind`; a device that is not in the
    table is an error, never a default."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {device_kind!r}; add it to "
            "utils/profiling.PEAK_HBM_BYTES_PER_S with its source") from None


def traversal_roofline(n_rays: int, depth: int, mean_iters: float,
                       device_kind: str):
    """First-order cost model of the traversal loop per frame on
    `device_kind`.

    Memory per iteration: one packed (8 B) node fetch per active ray plus
    ~32 B of state traffic per ray when the loop spills; compute is a few
    dozen integer/float ops per ray per iteration, so the bound is modeled
    from bytes over peak HBM bandwidth. Returns a dict with the ideal frame
    time and implied rays/s ceiling."""
    bytes_per_iter = 8 + 32
    total_bytes = n_rays * mean_iters * bytes_per_iter
    t_ideal = total_bytes / peak_hbm_bytes_per_s(device_kind)
    return {
        "bytes": total_bytes,
        "ideal_s": t_ideal,
        "rays_per_s_ceiling": n_rays / t_ideal if t_ideal else float("inf"),
    }


def iter_stats(iters) -> dict:
    it = np.asarray(iters)
    return {
        "mean": float(it.mean()),
        "p50": float(np.percentile(it, 50)),
        "p99": float(np.percentile(it, 99)),
        "max": int(it.max()),
    }


def device_op_breakdown(fn, *args, logdir: str, calls: int = 3,
                        top: int = 30) -> list:
    """Run `fn(*args)` under a jax.profiler trace and aggregate DEVICE-side
    op durations from the emitted Chrome trace (per-fusion launch overhead,
    while-loop trip costs). Returns [(op_name, total_ms, count)]
    sorted by total time, one entry per distinct HLO op/fusion name.

    fn must force execution itself (e.g. return a value the caller floats,
    or block); each of `calls` invocations is recorded, so divide by
    `calls` for per-call numbers."""
    import glob
    import gzip
    import json
    from collections import Counter

    import jax

    fn(*args)  # warm (compile outside the trace)
    with jax.profiler.trace(logdir):
        for _ in range(calls):
            fn(*args)
    paths = sorted(glob.glob(f"{logdir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        return []
    with gzip.open(paths[-1]) as f:
        tr = json.load(f)
    ev = tr.get("traceEvents", [])
    pids = {e["pid"]: e.get("args", {}).get("name", "")
            for e in ev if e.get("ph") == "M"
            and e.get("name") == "process_name"}
    agg, cnt = Counter(), Counter()
    for e in ev:
        if (e.get("ph") == "X" and "dur" in e
                and pids.get(e["pid"], "").startswith("/device")):
            agg[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    return [(name, dur / 1e3, cnt[name])
            for name, dur in agg.most_common(top)]
