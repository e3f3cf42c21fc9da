"""What every cell shares: finding cells, configurations, workloads and
metric readers by name; the benchmark's own weights and inputs; the port
and the control put behind one interface; the profiler's reading; the
result line."""
