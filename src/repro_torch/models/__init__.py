"""Model definitions of the port (the generalized recommendation model)."""
