"""Live serving runtime of the port: request bucketing and the threaded
runtime with its online controllers."""
