"""Stage timing, spans and trace capture (``hyperres/utils``). The
reference's ``enable_compilation_cache`` (XLA's persistent compile cache)
has no counterpart: the port's kernels are built by nvcc into ``build/``
at first use (``kernels._build``)."""

from .profiling import (
    StageTimer, clear, count, profile_trace, records, span, tracing,
)

__all__ = ["StageTimer", "profile_trace", "span", "count", "tracing",
           "records", "clear"]
