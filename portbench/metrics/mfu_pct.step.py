"""The counted operations of the window's outer steps over its length times
the f32 peak: the DIP fit's convolutions and B1."""

from yardstick.shares import mfu_pct as read  # noqa: F401
