"""Test and smoke fixtures of the port (no checkpoint or outside file)."""
