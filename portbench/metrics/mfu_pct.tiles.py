"""The counted operations of the window's requests over its length times
the f32 peak: B1, the reconstruction, the step sizes' power iterations and
the SVT's products."""

from yardstick.shares import mfu_pct as read  # noqa: F401
