"""Host-side helpers: parameter and FLOP counts, profiler traces, meters."""
