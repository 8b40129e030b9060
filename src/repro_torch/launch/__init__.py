"""Launchers of the port (``make_sector`` so far; the trainer follows)."""
