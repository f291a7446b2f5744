"""Stats aggregation, checkpoint/resume, and the numpy-in/numpy-out adapter
of the port's torch functions (host)."""
