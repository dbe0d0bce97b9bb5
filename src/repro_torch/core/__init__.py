"""The port's copies of the planning core: the QoE model, workload
statistics and the length-aware stage partition (paper §4)."""
