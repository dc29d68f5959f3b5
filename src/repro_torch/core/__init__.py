"""numpy/scipy core of the port: graphs, LUTs, workloads, ILP, geometry."""
