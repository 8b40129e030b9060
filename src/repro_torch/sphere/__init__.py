"""The Sphere dataflow API and its SPMD executor (port of ``repro.sphere``)."""
