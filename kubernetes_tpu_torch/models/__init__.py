"""Scheduling drivers: the serial scan (batch), the wave probe (probe),
the host replay (replay) and the wave backlog driver (wave)."""
