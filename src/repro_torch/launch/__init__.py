"""Launchers of the port: serving (``serve``), training (``train``, with
``make_sector``) and the rank grids they run on (``mesh``)."""
