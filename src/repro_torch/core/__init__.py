"""Records, the flat bucket shuffle and Terasort (port of ``repro.core``)."""
