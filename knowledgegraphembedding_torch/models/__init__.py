"""Scorers and the parameter dict (init, gather + score forward)."""
