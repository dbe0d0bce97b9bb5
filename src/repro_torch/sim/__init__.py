"""The port's copy of the discrete-event cluster simulator (paper §6):
workloads, simulated instances and cluster policies over the copied
control plane, the cost model priced on a chip (``kernels.cost.H100`` by
default), QoE profiling and the experiment driver."""
