"""Sector's topology (port of ``repro.sector``; only ``topology`` so far)."""
