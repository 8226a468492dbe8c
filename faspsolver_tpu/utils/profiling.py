"""Profiling and memory accounting.

Reference: wall-clock phase timers (AuxTiming.c / fasp_cputime) and
DEBUG-mode memory accounting (AuxMemory.c fasp_mem_usage).  Here:
jax.profiler traces (viewable in TensorBoard/Perfetto) plus pytree
device-memory reports.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device trace for the enclosed block
    (jax.profiler; open with TensorBoard or ui.perfetto.dev)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (fasp_cputime-style labeled phases)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def timed_phase(label: str, results: dict = None) -> Iterator[None]:
    """Wall-clock phase timing (reference: fasp_gettime bracketing)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = results.get(label, 0.0) + dt


def tree_nbytes(tree) -> int:
    """Total bytes of every array leaf in a pytree (reference:
    fasp_mem_usage accounting) — e.g. the device footprint of an AMG
    hierarchy."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif hasattr(leaf, "size") and hasattr(leaf, "dtype"):
            total += int(leaf.size) * np.dtype(leaf.dtype).itemsize
    return total


def memory_report(tree, label: str = "pytree") -> str:
    b = tree_nbytes(tree)
    return f"{label}: {b / 1e6:.2f} MB across " \
           f"{len(jax.tree_util.tree_leaves(tree))} arrays"
