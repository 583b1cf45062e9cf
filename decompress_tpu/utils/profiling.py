"""Tracing / profiling helpers (SURVEY §5.1 parity).

The reference uses landmarks auto-instrumentation (`[@@@landmark
"auto"]`, de.ml:1) plus median-of-N timing with GC compaction in its
bench (b.ml:11–20).  The equivalents here: `jax.profiler` trace
contexts (Perfetto-compatible) and annotated named scopes on the codec
stages.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed codec calls.

    View with Perfetto / TensorBoard.  Usage::

        with profiling.device_trace("trace"):
            de.deflate(data, 6)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named profiler scope for a codec stage (shows up in traces)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
