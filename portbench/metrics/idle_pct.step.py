"""The share of the traced stretch of outer steps in which the card ran
nothing."""

from yardstick.shares import idle_pct as read  # noqa: F401
