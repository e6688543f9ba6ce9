"""Launchers: the serving loop and the INC telemetry around it."""
