"""Records, the bucket shuffles, Terasort, MapReduce, streams and UDFs
(port of ``repro.core``)."""
