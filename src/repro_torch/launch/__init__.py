"""Launchers of the port: the serving launcher (``serve``) and
``make_sector`` (``train``; the trainer follows)."""
