"""The port's copies of the simulator's workload generator and SLO
metrics (the discrete-event simulator itself is not ported yet)."""
