"""Stage timing and trace capture (``hyperres/utils``). The reference's
``enable_compilation_cache`` (XLA's persistent compile cache) has no
counterpart: the port's kernels are built by nvcc into ``build/`` at
first use (``kernels._build``)."""

from .profiling import StageTimer, profile_trace

__all__ = ["StageTimer", "profile_trace"]
