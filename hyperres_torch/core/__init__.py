"""Port-owned copies of ``hyperres/core`` (constants, CRS math, grids,
config dataclasses), so that the port imports nothing of ``hyperres``."""
